"""Analytic laminar base flows, one module a kind, found by the name in a
configuration's `base_flow.kind`: each has `evaluate(spec, x)`, the base
velocity [ndim, pts..., nel] at the node coordinates x (same shape), in
numpy."""

import importlib


def evaluate(spec: dict, x):
    return importlib.import_module(f"{__name__}.{spec['kind']}").evaluate(spec, x)
