"""What a run loads: neither JAX nor the JAX package, by whole top-level
module names (``etmppo_tpu_torch`` begins with ``etmppo_tpu``), and the
reference nothing of the port."""
import json
import subprocess
import sys

from portbench import harness

PROBE = """
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
from portbench import harness
from conftest import load, tiny
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_names(body: str):
    code = PROBE.format(root=str(harness.ROOT),
                        tests=str(harness.HERE / "tests"), body=body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=harness.ROOT,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_rehearsal_loads_no_jax_and_no_jax_package():
    body = "\n".join(
        f"harness.run_cell(tiny(load({n!r})), 5, 0.3, {t}, "
        f"'cpu', time.perf_counter())"
        for n in ("minigrid_s9.train", "minigrid_s9.serve64")
        for t in (False, True))
    names = top_level_names(body + "\nimport portbench.control")
    assert "etmppo_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    """The reference's modules, every env file among them, found by glob."""
    envs = sorted(p.stem for p in
                  (harness.HERE / "reference").glob("env_*.py"))
    assert {"env_minigrid", "env_mysterypath_grid",
            "env_mortarmayhem_grid"} <= set(envs)
    names = top_level_names(
        "import portbench.reference.model, portbench.reference.envs, "
        "portbench.reference.ppo, portbench.compare, portbench.yardstick\n"
        + "".join(f"import portbench.reference.{e}\n" for e in envs))
    assert not names & {"etmppo_tpu_torch", *harness.FORBIDDEN}
