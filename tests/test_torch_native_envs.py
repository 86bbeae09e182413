"""The port's native (C++) env engine against the JAX package's.

Both wrap the same C++ source (the port's ``csrc/env_batch.cpp`` is a copy
of ``native/env_batch.cpp``) built by g++ with the same flags, so on the
same seed and actions the two give the same bits: every comparison here is
exact.
"""
import os
import shutil

import numpy as np
import pytest

from etmppo_tpu.envs import native as jax_native
from etmppo_tpu_torch.envs import native
from etmppo_tpu_torch.envs.native import (ENV_TYPE_IDS, NativeEnvBatch,
                                          build_native_library)
from etmppo_tpu_torch.utils import build

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="needs a C++ toolchain")

REPO = os.path.join(os.path.dirname(__file__), "..")
NATIVE_DIR = os.path.join(REPO, "native")


def test_source_is_a_copy_of_the_jax_packages():
    with open(os.path.join(NATIVE_DIR, "env_batch.cpp"), "rb") as f:
        theirs = f.read()
    assert native.SOURCE.read_bytes() == theirs
    assert ENV_TYPE_IDS == jax_native.ENV_TYPE_IDS


def test_builds_into_its_own_directory(tmp_path, monkeypatch):
    """A fresh build goes to the build directory under a name keyed by the
    source and flags, beside g++'s report; nothing under native/ is
    written."""
    jax_native.build_native_library()   # the JAX package's library, fresh
    before = {n: os.path.getmtime(os.path.join(NATIVE_DIR, n))
              for n in os.listdir(NATIVE_DIR)}
    assert native.library_path().parent == build.BUILD_DIR
    assert build.BUILD_DIR.name == "_build"
    assert build.BUILD_DIR.parent.name == "etmppo_tpu_torch"
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    path = build_native_library()
    assert path.parent == tmp_path / "_build" and path.exists()
    assert path.name.startswith("env_batch_") and path.suffix == ".so"
    assert build_native_library() == path            # reused, not rebuilt
    assert sorted(os.listdir(tmp_path / "_build")) == sorted(
        [path.name, build.report_path(path).name])   # no temporary
    batch = NativeEnvBatch("PocMemoryEnv-native")
    assert batch.observation_shape == (3,)
    after = {n: os.path.getmtime(os.path.join(NATIVE_DIR, n))
             for n in os.listdir(NATIVE_DIR)}
    assert after == before


@pytest.mark.parametrize("env_type,spec", [
    ("CartPole-native", ((4,), (2,), 200)),
    ("CartPoleMasked-native", ((4,), (2,), 200)),
    ("PocMemoryEnv-native", ((3,), (2,), 32)),
])
def test_spec(env_type, spec):
    ours = NativeEnvBatch(env_type, seed=1)
    theirs = jax_native.NativeEnvBatch(env_type, seed=1)
    for batch in (ours, theirs):
        assert (batch.observation_shape, batch.action_branches,
                batch.max_episode_steps) == spec
        assert batch.info_keys == ("reward", "length", "success")
    with pytest.raises(ValueError, match="unknown native env type"):
        NativeEnvBatch("Pong-native")


def _run(batch, n_envs: int, actions: np.ndarray):
    batch.start(n_envs)
    try:
        trace = [batch.reset_all()]
        for a in actions:
            obs, rewards, dones, infos = batch.step(a)
            trace += [obs, rewards, dones]
            trace.append(np.asarray(
                [[i["reward"], i["length"], i["success"]] if i else [-1] * 3
                 for i in infos], np.float32))
    finally:
        batch.close()
    return trace


@pytest.mark.parametrize("env_type", sorted(ENV_TYPE_IDS))
def test_bit_equal_to_the_jax_engine(env_type):
    """8 envs, one seed, 300 steps of seeded random actions: obs, rewards,
    dones and episode infos bit-equal to the JAX package's engine."""
    actions = np.random.default_rng(0).integers(0, 2, (300, 8, 1))
    ours = _run(NativeEnvBatch(env_type, seed=5), 8, actions)
    theirs = _run(jax_native.NativeEnvBatch(env_type, seed=5), 8, actions)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    dones = np.stack(ours[2::4])
    assert dones.any()       # episodes end, so auto-reset is covered


def test_results_do_not_depend_on_the_thread_count():
    """Each env draws from its own generator: 1 thread and 4 threads over
    16 envs give the same bits."""
    actions = np.random.default_rng(1).integers(0, 2, (100, 16, 1))
    one = _run(NativeEnvBatch("PocMemoryEnv-native", seed=3, n_threads=1),
               16, actions)
    four = _run(NativeEnvBatch("PocMemoryEnv-native", seed=3, n_threads=4),
                16, actions)
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a, b)
