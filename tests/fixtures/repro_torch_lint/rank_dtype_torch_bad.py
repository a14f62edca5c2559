"""Known-bad rank-cost module: torch's own narrow float spellings."""
import torch


def path_costs(weights, paths):
    acc = torch.zeros(len(paths), dtype=torch.float)  # torch.float is f32
    w = torch.as_tensor(weights).half()  # a float16 cast
    for col in paths.T:
        acc += w[col].float()  # a float32 cast
    return acc.to(torch.half), acc.bfloat16()
