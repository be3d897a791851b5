"""TL006: DIAG_KEYS out of step with the history dicts."""
import torch

DIAG_KEYS = ("grad_norm_mean", "eta", "update_norm", "tx_energy")


def _round_math(norms, tx):
    diag_core = {"grad_norm_mean": torch.mean(norms), "tx_peak": tx.max()}
    return diag_core


def _round_tail(diag_core, r, y):
    diag = {**diag_core, "eta": r.eta}
    return diag
