"""TL000: a suppression that gives its reason."""
import torch


def stage(t):
    return t.item()  # tracelint: disable=TL001 host staging, outside the round
