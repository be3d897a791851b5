"""TL006: every DIAG_KEYS entry written, nothing else."""
import torch

DIAG_KEYS = ("grad_norm_mean", "eta", "update_norm", "tx_energy")


def _round_math(norms, tx):
    diag_core = {"grad_norm_mean": torch.mean(norms), "tx_energy": tx.sum()}
    return diag_core


def _round_tail(diag_core, r, y):
    diag = {**diag_core, "eta": r.eta, "update_norm": y.norm()}
    return diag
