"""TL000: a suppression without a reason."""
import torch


def stage(t):
    return t.item()  # tracelint: disable=TL001
