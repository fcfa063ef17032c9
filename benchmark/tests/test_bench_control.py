"""The comparison's control and its faults, at a small size: the plain
reference in float32 in the program's place, and the timed path broken
underneath a whole run, each has to come out not correct."""

import pytest
import torch

import control
import harness
from conftest import TINY

CELLS = ["channel3d-re7500.eigs", "duct3d-re1000.growth", "duct3d-re1000.eigs"]


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_fails(cell, root):
    """On three seeds the float32 reference exceeds a limit of the cell."""
    for seed, values, correct, _ in control.control_readings(cell, [11, 12, 13], 3, root, "cpu",
                                                             TINY[cell.split(".")[0]]):
        assert not correct, (seed, values)


def _unchanged(self, x, stats=None):
    """A step that returns its state unchanged."""
    return {k: v.clone() for k, v in x.items()}


def _altered(orig):
    def op(self, x, stats=None):
        y = orig(self, x, stats=stats)
        u = y["u"].clone()
        u.view(-1)[u.numel() // 2] += 1e-3 * float(u.abs().max())
        return {**y, "u": u}
    return op


def _norm_off(orig):
    """The driver's normalisation returning a norm (the projected matrix's
    entry) off by 1e-6 and the right vector."""
    def normalize(self, w):
        w, nrm = orig(self, w)
        return w, nrm * (1.0 + 1e-6)
    return normalize


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "altered", "coefficient"])
def test_broken_timed_path_is_not_correct(cell, fault, root, monkeypatch):
    """The whole run with the timed path broken: the program's propagator's
    matvec (and, in growth, its rmatvec) returns the input unchanged, or an
    answer with one entry altered; or the Krylov driver's projected matrix
    gets entries off by 1e-6 while its basis vectors stay right."""
    from neklab_tpu_torch.krylov.space import VectorSpace
    from neklab_tpu_torch.linops.exponential_propagator import ExponentialPropagator as EP

    if fault == "coefficient":
        monkeypatch.setattr(VectorSpace, "normalize", _norm_off(VectorSpace.normalize))
    else:
        names = ["matvec", "rmatvec"] if cell.endswith("growth") else ["matvec"]
        for name in names:
            orig = getattr(EP, name)
            monkeypatch.setattr(EP, name, _unchanged if fault == "unchanged" else _altered(orig))
    out = harness.run_cell(cell, 4242, 0.5, False, root, "cpu",
                           overrides=TINY[cell.split(".")[0]])
    assert out["correct"] is False and out["failed"] >= 1
    if fault == "coefficient":
        bad = {k for k, r in out["checks"].items() if not r["value"] <= r["limit"]}
        assert bad == {"bidiag_rel" if cell.endswith("growth") else "hessenberg_rel"}, bad


def test_limits_sit_between_the_port_and_the_control(root):
    """At the small size the port reads far below every limit (the schema
    test) and the control above one: the limits are not vacuous here."""
    for cell in CELLS:
        limits = harness.resolve(cell, root)["limits"]
        assert all(1e-13 <= v <= 1e-4 for v in limits.values()), (cell, limits)
    assert torch.backends.cuda.matmul.allow_tf32 is False
