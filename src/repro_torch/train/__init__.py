"""Training: AdamW, the train step, gradient compression, checkpoints and
the fault-tolerant supervisor (port of `repro.train`)."""
