"""The reference values of chip_smoke.py's phase 18 (`TS_REF_SIGMA`,
`TS_REF_RES`), from the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tools/thermosyphon_reference.py --preset medium --f64 --platform cpu

Runs examples/thermosyphon_baseflow.py, unedited, with the given
arguments, and prints one more line, `ritz {...}`: the eigenvalues,
multipliers, Ritz residuals and matvec count of its eigensolve (the
example prints the eigenvalues, not the residuals). Imports the JAX
package; it is not part of the port.
"""

import json
import os
import runpy
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, ROOT)
    import neklab_tpu.analysis as analysis

    solve = analysis.linear_stability_analysis_fixed_point

    def reporting(*args, **kwargs):
        res = solve(*args, **kwargs)
        pairs = lambda zs: [[complex(z).real, complex(z).imag] for z in zs]
        print("ritz " + json.dumps({"eigvals": pairs(res.eigvals),
                                    "multipliers": pairs(res.multipliers),
                                    "residuals": [float(r) for r in res.residuals],
                                    "n_matvec": res.n_matvec}), flush=True)
        return res

    # the example imports the driver from the module when it runs
    analysis.linear_stability_analysis_fixed_point = reporting
    example = os.path.join(ROOT, "examples", "thermosyphon_baseflow.py")
    sys.argv = [example] + sys.argv[1:]
    runpy.run_path(example, run_name="__main__")


if __name__ == "__main__":
    main()
