"""`.par` runtime-parameter file reader (the Nek5000 INI schema).

Counterpart of `neklab_tpu.utils.parfile`: parses a case file (sections
GENERAL / PROBLEMTYPE / PRESSURE / VELOCITY / TEMPERATURE, case-insensitive
keys, `userParamXX` passed through) and maps it onto the port's
`FlowConfig`, so a Nek5000 case runs from its own configuration file.

Nek's conventions: a negative viscosity or conductivity means 1/|value| (a
Reynolds or Peclet number); stopAt = numSteps | endTime; timeStepper =
bdfN.
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Any

from ..models.navier_stokes import FlowConfig


def parse_par(path: str) -> dict[str, dict[str, str]]:
    """section -> key -> value, sections and keys lower-cased."""
    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    cp.optionxform = str.lower
    with open(path) as f:
        cp.read_string(f.read())
    return {sec.lower(): {k.lower(): v.strip() for k, v in cp[sec].items()}
            for sec in cp.sections()}


def _coef(value: str) -> float:
    """Nek's sign rule: a negative input means its reciprocal."""
    v = float(value)
    return 1.0 / abs(v) if v < 0 else v


@dataclasses.dataclass
class ParCase:
    """A parsed case: the solver's configuration and the run control it
    does not hold."""

    config: FlowConfig
    nsteps: int | None
    end_time: float | None
    start_from: str | None
    user_params: dict[int, float]
    n_perturbations: int
    equation: str
    target_cfl: float | None
    write_interval: float | None


def load_par(path: str, **overrides: Any) -> ParCase:
    """The case of a `.par` file; `overrides` replace FlowConfig fields
    (e.g. forcing_fn)."""
    par = parse_par(path)
    gen = par.get("general", {})
    vel = par.get("velocity", {})
    pres = par.get("pressure", {})
    temp = par.get("temperature", {})
    prob = par.get("problemtype", {})

    nscal = 1 if temp else 0
    kwargs: dict[str, Any] = dict(
        viscosity=_coef(vel.get("viscosity", "1.0")),
        rho=float(vel.get("density", "1.0")),
        dt=float(gen.get("dt", "1e-3")),
        vtol=float(vel.get("residualtol", "1e-8")),
        ptol=float(pres.get("residualtol", "1e-6")),
        nscal=nscal,
    )
    if nscal:
        kwargs["conductivity"] = (_coef(temp.get("conductivity", "1.0")),)
        kwargs["ttol"] = float(temp.get("residualtol", "1e-8"))
    ts = gen.get("timestepper", "bdf3").lower()
    if ts.startswith("bdf"):
        kwargs["torder"] = int(ts[3:])
    kwargs.update(overrides)
    cfg = FlowConfig(**kwargs)

    user = {int(k[len("userparam"):]): float(v) for k, v in gen.items()
            if k.startswith("userparam")}
    stop_at = gen.get("stopat", "numsteps").lower()
    nsteps = int(float(gen["numsteps"])) if "numsteps" in gen and stop_at == "numsteps" else None
    end_time = float(gen["endtime"]) if "endtime" in gen and stop_at == "endtime" else None
    start = gen.get("startfrom", "0")

    return ParCase(
        config=cfg,
        nsteps=nsteps,
        end_time=end_time,
        start_from=None if start in ("0", "") else start,
        user_params=user,
        n_perturbations=int(prob.get("numberofperturbations", "0") or 0),
        equation=prob.get("equation", "incompns").lower(),
        target_cfl=float(gen["targetcfl"]) if "targetcfl" in gen else None,
        write_interval=float(gen["writeinterval"]) if "writeinterval" in gen else None,
    )
