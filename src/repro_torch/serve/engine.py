"""Batched serving engine: slot batches over the decode step, with greedy /
temperature sampling and per-request completion tracking.

Port of `repro.serve.engine`.  The device work is two calls of the model —
`prefill` (prompts -> caches) and `decode_step` (one token for the whole
batch); the engine is the host-side loop around them.  Requests are served
`batch_slots` at a time; each chunk's prompts are left-padded with token 0
to the chunk's longest prompt, and prefill attends over the pads as the
reference does (there is no pad mask).  Sampling is greedy `argmax` at
temperature 0; otherwise it draws from a `torch.Generator` seeded from
`seed` (not the reference's JAX key, so sampled tokens differ from it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.model import Model


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # [T] int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, model: Model, batch_slots: int = 8,
                 max_seq: int = 512, seed: int = 0):
        self.model = model
        self.b = batch_slots
        self.max_seq = max_seq
        self.seed = seed
        self._gen: Optional[torch.Generator] = None

    @torch.inference_mode()
    def generate(self, requests: list[Request]) -> list[Request]:
        """Run all requests to completion, batch_slots at a time."""
        queue = list(requests)
        while queue:
            chunk, queue = queue[:self.b], queue[self.b:]
            self._run_chunk(chunk)
        return requests

    # ------------------------------------------------------------------
    def _run_chunk(self, chunk: list[Request]):
        b = len(chunk)
        tmax = max(len(r.prompt) for r in chunk)
        toks = np.zeros((b, tmax), np.int64)
        for i, r in enumerate(chunk):  # left-pad to align last prompt token
            toks[i, tmax - len(r.prompt):] = r.prompt
        dev = self.model.device
        state = self.model.init_decode_state(b, self.max_seq)
        logits, state = self.model.prefill(
            {"tokens": torch.from_numpy(toks).to(dev)}, state)
        cur = self._sample(logits[:, -1], chunk)
        for r, t in zip(chunk, cur):
            r.out_tokens.append(int(t))
        steps = max(r.max_new_tokens for r in chunk)
        for _ in range(steps - 1):
            token = torch.from_numpy(cur.astype(np.int64)).to(dev)[:, None]
            logits, state = self.model.decode_step(token, state)
            cur = self._sample(logits[:, -1], chunk)
            alive = False
            for r, t in zip(chunk, cur):
                if r.done or len(r.out_tokens) >= r.max_new_tokens:
                    r.done = True
                    continue
                r.out_tokens.append(int(t))
                if r.eos_id is not None and int(t) == r.eos_id:
                    r.done = True
                alive = alive or not r.done
            if not alive:
                break
        for r in chunk:
            r.done = True

    def _sample(self, logits: torch.Tensor, chunk) -> np.ndarray:
        temps = np.array([r.temperature for r in chunk], np.float32)
        greedy = torch.argmax(logits, dim=-1)
        if (temps == 0).all():
            return greedy.cpu().numpy().astype(np.int32)
        if self._gen is None:
            self._gen = torch.Generator(device=logits.device)
            self._gen.manual_seed(self.seed)
        t = torch.from_numpy(temps).to(logits.device)
        scaled = logits.float() / torch.clamp(t, min=1e-6)[:, None]
        sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                    generator=self._gen)[:, 0]
        pick = torch.where(t > 0, sampled, greedy)
        return pick.cpu().numpy().astype(np.int32)
