"""etmppo_tpu_torch's HTTP front end against the JAX package's.

Both packages' servers run a tiny PocMemory model saved by the JAX package
(3 streams, greedy) on ephemeral ports and get the same requests: JSON and
binary steps, /step_many, and every malformed body of
tests/test_serve_http.py. Statuses must be equal, actions and step counters
equal, values within rtol 1e-4, atol 1e-5 (float32 sums in another order),
and each error carries the phrase the JAX package's tests look for. The one
designed difference is ``X-Streams``: the port parses it as an integer, so
``03`` is accepted and a non-integer is a 400 with a parse message, where
the JAX package compares strings.
"""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from etmppo_tpu.config import load_config
from etmppo_tpu.envs.factory import create_env as jax_create_env
from etmppo_tpu.models.actor_critic import ActorCriticModel as JModel
from etmppo_tpu.serve_http import serve as jax_serve
from etmppo_tpu.training.checkpoint import save_model
from etmppo_tpu_torch import serve_http

torch.set_num_threads(1)

M = 3
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    cfg = load_config("etmppo_tpu/configs/poc_memory_env.yaml")
    cfg = dataclasses.replace(
        cfg, hidden_layer_size=16,
        transformer=dataclasses.replace(
            cfg.transformer, num_blocks=2, embed_dim=16, num_heads=2,
            memory_length=6))
    env = jax_create_env(cfg.environment)
    model = JModel(config=cfg, obs_shape=env.observation_shape,
                   action_branches=env.action_branches,
                   max_episode_steps=env.max_episode_steps)
    path = str(tmp_path_factory.mktemp("serve_http") / "tiny.nn")
    save_model(path, model.init_params(jax.random.PRNGKey(0)), cfg)
    httpds = [jax_serve(path, streams=M, port=0, greedy=True),
              serve_http.serve(path, streams=M, port=0, greedy=True,
                               device="cpu")]
    threads = [threading.Thread(target=h.serve_forever, daemon=True)
               for h in httpds]
    for thread in threads:
        thread.start()
    yield ([f"http://127.0.0.1:{h.server_address[1]}" for h in httpds],
           (M,) + tuple(env.observation_shape), env.max_episode_steps)
    for h, thread in zip(httpds, threads):
        h.shutdown()
        h.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()


def _request(base, path, body=None, headers=None):
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    headers = dict(headers or {})
    if body is not None and not isinstance(body, bytes):
        headers.setdefault("Content-Type", "application/json")
    req = urllib.request.Request(base + path, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _binary(base, path, array, **headers):
    headers = {"Content-Type": "application/octet-stream", **headers}
    data = array if isinstance(array, bytes) else array.astype("<f4").tobytes()
    return _request(base, path, data, headers)


def _both(bases, fn):
    """``fn(base)`` on the JAX server, then on the port's; the port's answer
    must equal JAX's."""
    (js, jr), (ts, tr) = [fn(base) for base in bases]
    assert ts == js, (tr, jr)
    if js == 200 and "values" in jr:
        np.testing.assert_array_equal(tr["actions"], jr["actions"])
        np.testing.assert_allclose(tr["values"], jr["values"], rtol=RTOL,
                                   atol=ATOL)
        assert tr["steps"] == jr["steps"]
    elif js == 200:
        assert tr == jr
    return tr, jr


def _reset_both(bases):
    _both(bases, lambda b: _request(b, "/reset", {"streams": list(range(M))}))


def test_info_matches(servers):
    bases, shape, max_ep = servers
    tr, _ = _both(bases, lambda b: _request(b, "/info"))
    assert tr["max_streams"] == M and tr["max_episode_steps"] == max_ep
    assert tuple(tr["observation_shape"]) == shape[1:] and tr["greedy"]
    _both(bases, lambda b: _request(b, "/nope"))


def test_json_and_binary_steps_match(servers):
    bases, shape, _ = servers
    rng = np.random.default_rng(5)
    _reset_both(bases)
    for _ in range(3):
        obs = rng.normal(size=shape).astype(np.float32)
        _both(bases, lambda b: _request(b, "/step", {"obs": obs.tolist()}))
    obs = rng.normal(size=shape).astype(np.float32)
    _both(bases, lambda b: _binary(b, "/step", obs, **{"X-Active": "1,0,1"}))
    obs_seq = rng.normal(size=(4,) + shape).astype(np.float32)
    _both(bases, lambda b: _request(b, "/step_many", {
        "obs_seq": obs_seq.tolist(), "active": [True, True, False]}))
    tr, _ = _both(bases, lambda b: _binary(b, "/step_many", obs_seq,
                                          **{"X-T": "4"}))
    assert np.shape(tr["actions"]) == (4, M, 1) and tr["steps"] == [12, 11, 8]


def test_binary_matches_json_on_the_port(servers):
    bases, shape, _ = servers
    obs = np.random.default_rng(21).normal(size=shape).astype(np.float32)
    out = []
    for send in (lambda b: _request(b, "/step", {"obs": obs.tolist()}),
                 lambda b: _binary(b, "/step", obs)):
        _request(bases[1], "/reset", {"streams": list(range(M))})
        out.append(send(bases[1]))
    (s1, via_json), (s2, via_bin) = out
    assert s1 == s2 == 200 and via_json == via_bin


# Each malformed request, with the phrase both servers' errors carry.
MALFORMED = {
    "reset id out of range": (lambda b, shape: _request(
        b, "/reset", {"streams": [99]}), "out of range"),
    "obs of the wrong shape": (lambda b, shape: _request(
        b, "/step", {"obs": [[0.0]]}), "obs must be"),
    "body not a JSON object": (lambda b, shape: _request(
        b, "/step", [1, 2]), "JSON object"),
    "body not JSON": (lambda b, shape: _request(
        b, "/step", b"{", {"Content-Type": "application/json"}),
        "bad request body"),
    "obs null": (lambda b, shape: _request(b, "/step", {"obs": None}), ""),
    "obs missing": (lambda b, shape: _request(b, "/step", {}), "obs"),
    "obs_seq a string": (lambda b, shape: _request(
        b, "/step_many", {"obs_seq": "nope"}), ""),
    "obs_seq of the wrong shape": (lambda b, shape: _request(
        b, "/step_many", {"obs_seq": np.zeros((2, M, 2)).tolist()}),
        "obs_seq must be"),
    "active too short": (lambda b, shape: _request(
        b, "/step", {"obs": np.zeros(shape).tolist(), "active": [True]}),
        "active"),
    "binary body of 7 bytes": (lambda b, shape: _binary(
        b, "/step", b"\x00" * 7), "float32"),
    "binary /step of two frames": (lambda b, shape: _binary(
        b, "/step", np.zeros((2,) + shape)), "/step_many"),
    "binary /step_many without X-T": (lambda b, shape: _binary(
        b, "/step_many", np.zeros((2,) + shape)), "X-T"),
    "binary /step_many with a wrong X-T": (lambda b, shape: _binary(
        b, "/step_many", np.zeros((4,) + shape), **{"X-T": "2"}), "X-T=2"),
    "X-T not an integer": (lambda b, shape: _binary(
        b, "/step_many", np.zeros((4,) + shape), **{"X-T": "four"}),
        "X-T must be an integer"),
    "X-Active token not 0/1": (lambda b, shape: _binary(
        b, "/step_many", np.zeros((4,) + shape),
        **{"X-T": "4", "X-Active": "1,True,0"}), "X-Active"),
    "unknown POST path": (lambda b, shape: _request(b, "/nope", {}),
                          "unknown path"),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_requests_match(servers, case):
    bases, shape, _ = servers
    send, phrase = MALFORMED[case]
    _reset_both(bases)
    tr, jr = _both(bases, lambda b: send(b, shape))
    status = 404 if case == "unknown POST path" else 400
    assert (tr.get("error") is not None) and jr.get("error") is not None
    assert phrase in tr["error"] and phrase in jr["error"]
    assert _request(bases[1], "/info")[0] == 200   # still serving


def test_exhausted_streams_are_400(servers):
    bases, shape, max_ep = servers
    _reset_both(bases)
    obs_seq = np.zeros((max_ep + 2,) + shape, np.float32)
    tr, _ = _both(bases, lambda b: _binary(b, "/step_many", obs_seq,
                                          **{"X-T": str(max_ep + 2)}))
    assert tr["steps"] == [max_ep] * M
    tr, jr = _both(bases, lambda b: _binary(b, "/step", obs_seq[0]))
    assert "max_episode_steps" in tr["error"]


@pytest.mark.parametrize("value, port_status, jax_status", [
    ("3", 200, 200), ("03", 200, 400), (" 3 ", 200, 200), ("4", 400, 400),
    ("three", 400, 400)])
def test_x_streams_is_parsed_as_an_integer(servers, value, port_status,
                                           jax_status):
    bases, shape, _ = servers
    _reset_both(bases)
    obs = np.zeros(shape, np.float32)
    (js, jr), (ts, tr) = [_binary(b, "/step", obs, **{"X-Streams": value})
                          for b in bases]
    assert (ts, js) == (port_status, jax_status)
    if value == "three":
        assert "X-Streams must be an integer" in tr["error"]
    elif ts == 400:
        assert "does not match" in tr["error"]


def test_serve_http_needs_a_gpu_by_default(servers, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "missing.nn")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_http.serve(path, streams=M, port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_http.main([f"--model={path}", "--port=0"])
