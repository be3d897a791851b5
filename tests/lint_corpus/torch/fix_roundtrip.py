"""--fix input: reasonless suppressions."""
import torch


def stage(t):
    a = t.item()  # tracelint: disable=TL001
    # tracelint: disable=TL002,TL003
    b = torch.randn(3)
    return a, b
