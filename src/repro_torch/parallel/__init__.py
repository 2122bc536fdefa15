"""Parameter and activation layouts on a `torch.distributed` device mesh."""
