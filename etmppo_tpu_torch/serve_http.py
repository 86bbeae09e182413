"""HTTP front end for ``PolicyServer`` (counterpart of
``etmppo_tpu/serve_http.py``): one process owns the device and the
per-stream K/V caches, remote clients drive episodes over HTTP.

    python -m etmppo_tpu_torch.serve_http --model models/run.nn \
        --streams 64 --port 8765 [--greedy] [--cpu]

It serves on the CUDA device unless ``--cpu`` is given, and raises without a
GPU. API (stdlib only on both sides):

* ``GET /info`` -> observation shape, action branches, stream count,
  episode budget and ``greedy``, so that clients can configure themselves.
* ``POST /reset`` body ``{"streams": [0, 3, ...]}`` -> ``{"ok": true}``.
* ``POST /step`` body ``{"obs": [[...], ...], "active": [true, ...]?}``:
  the full (streams, *obs_shape) batch as nested lists (rows of inactive
  streams may hold anything) -> ``{"actions", "values", "steps"}``.
* ``POST /step_many`` body ``{"obs_seq": ..., "active": ...?}``: T steps of
  (streams, *obs_shape), run back to back (``PolicyServer.step_many``;
  exhausted streams freeze instead of raising) -> actions (T, streams,
  branches), values (T, streams) and steps.

Binary observations: the same routes with ``Content-Type:
application/octet-stream`` and a raw little-endian float32 body,
(streams, *obs_shape) for /step and (T, streams, *obs_shape) for /step_many
with a required ``X-T`` header carrying T. The byte count must match
exactly: a mismatch is a 400, never a reshape. An optional ``X-Streams``
header is parsed as an integer and must equal the server's stream count; an
optional ``X-Active`` header carries the mask as comma-separated 0/1 tokens.
Responses stay JSON.

Requests are served one at a time by one thread, which owns the tensors:
batching across streams, not across requests, is the throughput mechanism.
A client that stalls is cut off after 30 s. Bad input is a 400 with the
message, an unknown path a 404, a server fault a 500.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np


def make_handler(server_obj):
    class Handler(BaseHTTPRequestHandler):
        policy = server_obj
        # Without a socket timeout one stalled client would wedge the
        # single-threaded serving loop for everyone.
        timeout = 30.0

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path != "/info":
                return self._send(404, {"error": "unknown path"})
            p = self.policy
            self._send(200, {
                "observation_shape": list(p.observation_shape),
                "action_branches": list(p.action_branches),
                "max_streams": p.max_streams,
                "max_episode_steps": p.max_episode_steps,
                "greedy": p.greedy,
            })

        def _binary_request(self, body: bytes):
            """A raw float32 LE obs body as the equivalent JSON request. The
            layout is never inferred from the byte count alone: /step takes
            exactly one (streams, *obs_shape) frame, /step_many exactly the
            T frames its X-T header states."""
            p = self.policy
            streams_hdr = self.headers.get("X-Streams")
            if streams_hdr is not None:
                try:
                    streams = int(streams_hdr)
                except ValueError:
                    raise ValueError(
                        f"X-Streams must be an integer, got {streams_hdr!r}")
                if streams != p.max_streams:
                    raise ValueError(
                        f"X-Streams={streams} does not match the server's "
                        f"{p.max_streams} streams (see /info)")
            frame = int(p.max_streams
                        * np.prod(p.observation_shape, dtype=np.int64))
            n = len(body) // 4
            if len(body) % 4 or n == 0 or n % frame:
                raise ValueError(
                    f"binary body must be k * {frame} float32 values "
                    f"({p.max_streams} streams x obs "
                    f"{tuple(p.observation_shape)}), got {len(body)} bytes")
            flat = np.frombuffer(body, dtype="<f4")
            req = {}
            if self.path == "/step":
                if n != frame:
                    raise ValueError(
                        f"/step binary body must be exactly {frame} float32 "
                        f"values, got {n} (use /step_many for T-step bodies)")
                req["obs"] = flat.reshape(
                    (p.max_streams,) + tuple(p.observation_shape))
            else:
                t_hdr = self.headers.get("X-T")
                if t_hdr is None:
                    raise ValueError(
                        "binary /step_many requires an X-T header carrying "
                        "the step count T (refusing to infer the time/stream "
                        "layout from the byte count alone)")
                try:
                    t = int(t_hdr)
                except ValueError:
                    raise ValueError(f"X-T must be an integer, got {t_hdr!r}")
                if t <= 0 or t * frame != n:
                    raise ValueError(
                        f"X-T={t} implies {t * frame} float32 values "
                        f"({p.max_streams} streams x obs "
                        f"{tuple(p.observation_shape)}), got {n}")
                req["obs_seq"] = flat.reshape(
                    (t, p.max_streams) + tuple(p.observation_shape))
            active_hdr = self.headers.get("X-Active")
            if active_hdr is not None:
                tokens = [v.strip() for v in active_hdr.split(",")]
                if any(tok not in ("0", "1") for tok in tokens):
                    raise ValueError(
                        "X-Active must be comma-separated 0/1 tokens, got "
                        f"{active_hdr!r}")
                req["active"] = [tok == "1" for tok in tokens]
            return req

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                ctype = (self.headers.get("Content-Type") or "").split(";")[0]
                if ctype == "application/octet-stream":
                    req = self._binary_request(body)
                else:
                    req = json.loads(body or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._send(400, {"error": f"bad request body: {e}"})
            if not isinstance(req, dict):
                return self._send(400, {
                    "error": f"request body must be a JSON object, "
                             f"got {type(req).__name__}"})
            try:
                if self.path == "/reset":
                    self.policy.reset(req.get("streams", []))
                    return self._send(200, {"ok": True})
                if self.path in ("/step", "/step_many"):
                    active = req.get("active")
                    if active is not None:
                        active = np.asarray(active, bool)
                    if self.path == "/step":
                        actions, values = self.policy.step(
                            np.asarray(req["obs"], np.float32), active=active)
                    else:
                        actions, values = self.policy.step_many(
                            np.asarray(req["obs_seq"], np.float32),
                            active=active)
                    return self._send(200, {
                        "actions": actions.tolist(),
                        "values": values.tolist(),
                        "steps": self.policy.steps.tolist(),
                    })
                return self._send(404, {"error": "unknown path"})
            except (ValueError, KeyError, TypeError) as e:
                # Validation errors (shape, exhausted streams, bad ids) and
                # malformed field types (e.g. {"obs": null}) are the
                # client's: a 400 with the message.
                return self._send(400, {"error": str(e)})
            except AttributeError:
                # An AttributeError out of PolicyServer is a server fault.
                traceback.print_exc(file=sys.stderr)
                return self._send(500, {"error": "internal server error"})

    return Handler


def serve(model_path: str, streams: int, port: int, greedy: bool = False,
          host: str = "127.0.0.1", device="cuda") -> HTTPServer:
    """Builds the PolicyServer on ``device``, resets every stream and
    returns a ready (unstarted) HTTPServer; ``port=0`` takes a free port."""
    from .serve import PolicyServer
    policy = PolicyServer(model_path, max_streams=streams, greedy=greedy,
                          device=device)
    policy.reset(range(streams))
    return HTTPServer((host, port), make_handler(policy))


def main(argv=None):
    ap = argparse.ArgumentParser(description="HTTP policy serving")
    ap.add_argument("--model", required=True)
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="Serve on the CPU instead of the GPU")
    a = ap.parse_args(argv)
    httpd = serve(a.model, a.streams, a.port, greedy=a.greedy, host=a.host,
                  device="cpu" if a.cpu else "cuda")
    print(f"serving {a.model} on http://{a.host}:{httpd.server_address[1]} "
          f"({a.streams} streams)")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
