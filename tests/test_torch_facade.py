"""The port's public surface against the reference's: ``Experiment.run``'s
keywords, ``Experiment.reset``, and the names ``repro_torch.core`` and
``repro_torch.fl`` export.  A call or import that the reference accepts
runs in the port, or raises ``NotImplementedError`` naming the ROADMAP item
that ports it."""
import importlib
import inspect

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.fl as jfl
from repro.fl.experiment import Experiment as JExperiment
import repro_torch.core as core
import repro_torch.fl as fl
from repro_torch.core.channel import ChannelConfig
from repro_torch.fed import runtime
from repro_torch.fl import DataSpec, EvalSpec, Experiment, ExperimentSpec, \
    ModelSpec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this file: intra-op threads on these small
    tensors stall on the loaded machine of the parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_spec():
    return ExperimentSpec(
        fl=runtime.FLConfig(num_devices=4, backend="kernels",
                            channel=ChannelConfig(num_devices=4,
                                                  channel_mean=1e-3),
                            smoothness_L=5.0, expected_loss_drop=2.0),
        data=DataSpec(num_train=200, num_test=50, batch_size=10),
        model=ModelSpec(hidden=8), eval=EvalSpec(every=2))


def _same_run(a, b):
    assert a.round == b.round
    assert a.history == b.history
    for k in b.params:
        assert torch.equal(a.params[k], b.params[k])


def test_run_takes_the_reference_driver_keywords():
    """run(n, driver="python", chunk_size=c) runs, as in the reference, and
    gives the run that the spec's own driver gives."""
    want = set(inspect.signature(JExperiment.run).parameters)
    got = set(inspect.signature(Experiment.run).parameters)
    assert {"driver", "chunk_size"} <= want & got
    a = Experiment(_tiny_spec(), device="cpu")
    a.run(3, driver="python", chunk_size=2)
    b = Experiment(_tiny_spec(), device="cpu")
    b.run(3)
    _same_run(a, b)


def test_run_with_the_scan_driver_names_its_item():
    """run(n, driver="scan") runs the compiled driver (ROADMAP queue 1 item
    8, which once raised here) and gives the python driver's run
    bitwise."""
    a = Experiment(_tiny_spec(), device="cpu")
    a.run(3, driver="scan", chunk_size=2)
    b = Experiment(_tiny_spec(), device="cpu")
    b.run(3, driver="python")
    _same_run(a, b)


def test_reset_starts_again_from_round_zero():
    """reset() is setup() run again: fresh params, optimizer and channel
    state, an empty history, and the same task."""
    a = Experiment(_tiny_spec(), device="cpu")
    a.run(3)
    task = a.task
    assert a.reset() is a
    assert a.round == 0 and a.history == {} and a.task is task
    a.run(3)
    b = Experiment(_tiny_spec(), device="cpu")
    b.run(3)
    _same_run(a, b)


def _port_twin(module: str, attr: str):
    """(has, value): whether the port's twin of ``module`` has ``attr``."""
    try:
        twin = importlib.import_module(module.replace("repro.", "repro_torch.",
                                                      1))
    except ImportError:
        return False, None
    return hasattr(twin, attr), getattr(twin, attr, None)


def test_core_exports_what_is_ported():
    """Every public name of repro.core whose defining module's twin in the
    port has it is exported by repro_torch.core as that object; the names
    not yet ported are not exported."""
    names = [n for n in dir(jcore) if not n.startswith("_")
             and not inspect.ismodule(getattr(jcore, n))]
    ported = []
    for name in names:
        obj = getattr(jcore, name)
        module = getattr(obj, "__module__", None)
        attr = getattr(obj, "__name__", name)
        if module is None or not module.startswith("repro.core."):
            # a constant: defined in the module that re-exports it
            module = next(m for m in ("repro.core.channel", "repro.core.ota",
                                      "repro.core.schemes")
                          if hasattr(importlib.import_module(m), name))
            attr = name
        has, value = _port_twin(module, attr)
        assert hasattr(core, name) == has, name
        if has:
            assert getattr(core, name) is value, name
            ported.append(name)
    assert {"ChannelConfig", "OTAConfig", "aggregate", "register_scheme",
            "get_scheme", "solve_problem3", "DEFAULT_B_MAX"} <= set(ported)
    assert core.SCHEMES == jcore.SCHEMES


def test_fl_exports_what_is_ported():
    """repro_torch.fl exports each name of repro.fl whose module the port
    has (ClientConfig among them), and none that waits for its item."""
    for name, (module, attr) in jfl._EXPORTS.items():
        has, value = _port_twin(module, attr)
        assert (name in fl.__all__) == has, name
        if has:
            assert getattr(fl, name) is value, name
    assert fl.ClientConfig().algo == "sgd"


def test_federated_split_weights_are_the_reference_weights():
    """FederatedSplit.weights(): each device's share of the examples, the
    paper's D_k / D_A, as the reference's."""
    from repro.data.datasets import FederatedSplit as JFederatedSplit
    from repro_torch.data.datasets import FederatedSplit
    indices = tuple(np.arange(n) for n in (3, 5, 2, 10))
    got = FederatedSplit(indices).weights()
    np.testing.assert_array_equal(got, JFederatedSplit(indices).weights())
    assert got.sum() == pytest.approx(1.0)
