"""Known-good rank-cost module: float64 in torch's own spellings."""
import torch


def path_costs(weights, paths):
    acc = torch.zeros(len(paths), dtype=torch.double)
    w = torch.as_tensor(weights).double()
    for col in paths.T:
        acc += w[col].to(torch.float64)
    return acc, float(acc.sum()), paths.long()
