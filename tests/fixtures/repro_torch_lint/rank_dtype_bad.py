"""Known-bad rank-cost module: narrow float dtypes in cost arithmetic."""
import numpy as np
import torch


def path_costs(weights, paths):
    acc = torch.zeros(len(paths), dtype=torch.float32)  # attribute
    for col in paths.T:
        acc += torch.as_tensor(weights[col].astype("float16"))  # string
    return acc.to(torch.bfloat16), np.float32(0)
