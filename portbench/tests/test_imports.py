"""What the benchmark loads: nothing of JAX or of the JAX package
(``jax``, ``jaxlib``, ``flax``, ``libfluid_tpu``) in the harness, the
port's adapter, the frame actions, the metric readers, the roofline table
or the reference; nothing of the port (``libfluid_tpu_torch``) in the
reference. Module names are compared by their top-level name, whole: the
port's name begins with the JAX package's."""

import json
import subprocess
import sys

from conftest import ROOT

JAX = ("jax", "jaxlib", "flax", "libfluid_tpu")

LOADED = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded_after(body: str, cwd=ROOT) -> set:
    """The top-level names of the modules loaded by a fresh interpreter that
    runs `body`."""
    code = LOADED.format(root=str(ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                         timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = loaded_after("""
import portbench.run, portbench.harness, portbench.system, portbench.readings, portbench.trace
from portbench import harness
b = harness.Bench(portbench.run.ROOT)
for kind in ("actions", "metrics", "roofline"):
    for p in (b.dir / kind).glob("*.py"):
        b.module(kind, p.stem)
""")
    assert not names & set(JAX), names & set(JAX)


def test_the_reference_loads_neither_jax_nor_the_port():
    names = loaded_after("""
import portbench.reference.compare, portbench.reference.control, portbench.reference.state_io
import portbench.reference.lf.sim.step, portbench.reference.lf.mesher.marching_cubes
import portbench.reference.lf.renderer.pathtrace, portbench.reference.lf.renderer.accel
""")
    assert not names & set(JAX + ("libfluid_tpu_torch",)), names & set(JAX + ("libfluid_tpu_torch",))


def test_a_run_loads_no_jax(tree):
    """A whole run on the CPU (the port loaded and driven) leaves no module of
    JAX or of the JAX package behind; the port itself is loaded."""
    names = loaded_after(f"""
from portbench import harness
harness.run_cell(harness.Bench({str(tree)!r}), "small64.render", 5, 0.0, False, device="cpu")
""")
    assert "libfluid_tpu_torch" in names
    assert not names & set(JAX), names & set(JAX)
