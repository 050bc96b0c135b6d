"""BAD: the torch shape of the serving pos-vector race — torch.from_numpy /
torch.as_tensor share the host buffer, and a non_blocking copy may still be
reading it when the buffer is mutated in place."""
import torch


def tick(pos_host, device):
    pos = torch.from_numpy(pos_host)          # shares pos_host's memory
    pos_dev = pos.to(device, non_blocking=True)
    pos_host += 1                             # races the async copy
    return pos_dev


def view_mutation(rows, device):
    t = torch.as_tensor(rows)                 # zero-copy on the host
    out = t.to(device, non_blocking=True)
    t[0] = -1                                 # writes rows under the copy
    return out
