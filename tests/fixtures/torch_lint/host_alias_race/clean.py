"""CLEAN: copy at the host/device boundary (torch.tensor copies), or copy
synchronously — the mutation then touches only the host's own buffer."""
import torch


def tick(pos_host, device):
    pos_dev = torch.tensor(pos_host).to(device, non_blocking=True)
    pos_host += 1
    return pos_dev


def synchronous(rows, device):
    t = torch.from_numpy(rows)
    out = t.to(device)                        # blocking copy
    t[0] = -1
    return out
