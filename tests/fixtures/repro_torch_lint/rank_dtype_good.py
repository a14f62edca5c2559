"""Known-good rank-cost module: float64 end to end."""
import numpy as np
import torch


def path_costs(weights, paths):
    acc = torch.zeros(len(paths), dtype=torch.float64)
    for col in paths.T:
        acc += torch.as_tensor(weights[col].astype("float64"))
    return acc.double(), np.float64(0), paths.to(torch.int32)
