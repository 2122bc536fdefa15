"""The comparison that decides `correct`: an answer of the program against
the plain reference's answer to the same query on the same tables.

Both answers are {column: tensor} of their valid rows.  The numbers
compared, each with a limit of its own from the traffic file:

- `columns_off`: columns in one answer and not in the other;
- `rows_off`: rows whose key (the query's key columns) is in one answer
  and not in the other, counted with multiplicity;
- `int_off`: values of the other integer columns that differ, once the
  rows are matched by key;
- `rel_err`: the largest relative error of a floating-point column, once
  the rows are matched by key, against max(|reference|, 1).

Where the columns or keys differ, the value columns are not compared and
their numbers are None, which fails their limits.
"""

import torch


def _by_key(cols: dict, keys) -> dict:
    """`cols` sorted by the key columns, lexicographically."""
    n = cols[keys[0]].shape[0]
    order = torch.arange(n, device=cols[keys[0]].device)
    for k in reversed(keys):
        order = order[torch.argsort(cols[k][order], stable=True)]
    return {c: t[order] for c, t in cols.items()}


def _rows_off(got: dict, want: dict, keys) -> int:
    g = torch.stack([got[k].to(torch.int64) for k in keys], dim=1)
    w = torch.stack([want[k].to(torch.int64) for k in keys], dim=1)
    both = torch.cat([g, w])
    if both.shape[0] == 0:
        return 0
    _, inv = torch.unique(both, dim=0, return_inverse=True)
    size = int(inv.max()) + 1
    cg = torch.bincount(inv[:g.shape[0]], minlength=size)
    cw = torch.bincount(inv[g.shape[0]:], minlength=size)
    return int((cg - cw).abs().sum())


def compare(got: dict, want: dict, keys) -> dict:
    """The numbers compared for one answer (see the module's docstring)."""
    out = {"columns_off": len(set(got) ^ set(want)), "rows_off": None,
           "int_off": None, "rel_err": None}
    if out["columns_off"]:
        return out
    out["rows_off"] = _rows_off(got, want, keys)
    if out["rows_off"] or got[keys[0]].shape[0] != want[keys[0]].shape[0]:
        return out
    g, w = _by_key(got, keys), _by_key(want, keys)
    int_off, rel = 0, 0.0
    for c in want:
        if c in keys:
            continue
        a, b = g[c], w[c]
        if b.is_floating_point() or a.is_floating_point():
            a, b = a.to(torch.float64), b.to(torch.float64)
            if b.numel():
                err = (a - b).abs() / b.abs().clamp_min(1.0)
                rel = max(rel, float(torch.nan_to_num(err, nan=float("inf"))
                                     .max()))
        else:
            int_off += int((a != b).sum())
    out["int_off"], out["rel_err"] = int_off, rel
    return out


def worst(readings) -> dict:
    """The worst of several answers' numbers, name by name (None wins)."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            if k not in out:
                out[k] = v
            elif out[k] is not None:
                out[k] = None if v is None else max(out[k], v)
    return out


def passes(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit; a number without a reading, or
    without a limit, fails."""
    return all(numbers.get(k) is not None and k in limits
               and numbers[k] <= limits[k] for k in numbers)
