"""What the benchmark loads: no JAX, jaxlib, flax, optax nor the JAX
package (top-level names compared whole, so the port, whose name begins
with the JAX package's, passes), and a reference that loads nothing of the
port."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
BANNED = ["jax", "jaxlib", "flax", "optax", "scgib_tpu"]


def _loaded(code: str):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys\nsys.path.insert(0, {str(ROOT)!r})"
         f"\n{code}\nprint(sorted({{m.split('.')[0] for m in sys.modules}}))"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_run_and_every_reader_load_no_jax():
    metrics = [m["name"] for kind in ("end_to_end", "per_layer")
               for m in json.loads((ROOT / "BENCHMARK.json").read_text())[
                   kind]]
    names = _loaded(
        "from port_bench import run, check, drivers, trace, counts, "
        "roofline, faults, calibrate\n"
        "import torch.profiler\n"
        f"for m in {metrics!r}:\n    run.reader(m)\n")
    assert "scgib_tpu_torch" in names          # the program is loaded
    assert not names & set(BANNED), names & set(BANNED)


def test_reference_loads_nothing_of_the_port():
    names = _loaded("from port_bench.reference import model, pack, steps")
    assert "scgib_tpu_torch" not in names
    assert not names & set(BANNED)
