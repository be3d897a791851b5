"""Serving step builders on one card (the port of ``repro/launch/serve.py``):
prefill, prefill that writes the decode cache, and single-token greedy
decode.

Each builder takes ``cfg`` and a ``device`` (default ``"cuda"``; raises
without a card) in place of the reference's mesh, and returns the step
function; the steps run under ``torch.inference_mode()`` and move the
token batch to the device (the params and the cache must be there
already).  The reference's ``in_shardings_fn``, context-parallel decode and
the sequence-sharded cache (``context_parallel``, ``shard_cache_seq``)
wait for ROADMAP queue 1 item 15.  ``serve_metrics`` serves a
``MemoryRecorder``'s latest events over HTTP, to watch a long FL run.

    prefill = build_prefill_cache_step(cfg, "cuda", cache_len=S + n)
    ids, cache = prefill(params, {"tokens": prompt})         # prompt [B, S]
    decode = build_decode_step(cfg, "cuda")
    for pos in range(S, S + n):
        ids, cache = decode(params, cache, ids[:, None], pos)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _greedy(params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Next-token ids [B] int32 from the last position's hidden state."""
    last = hidden[:, -1, :]
    logits = (last @ L.unembed_matrix(params["emb"], cfg)).float()
    return torch.argmax(logits, dim=-1).to(torch.int32)


def build_prefill_step(cfg: ModelConfig, device="cuda"):
    """prefill_step(params, batch) -> next-token ids [B] int32: the full
    forward over the prompt and a greedy first token (no cache)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill_step(params, batch):
        x = T.forward_hidden(params, cfg,
                             {"tokens": batch["tokens"].to(dev)})
        return _greedy(params, cfg, x)

    return prefill_step


def build_prefill_cache_step(cfg: ModelConfig, device="cuda", *,
                             cache_len: int):
    """prefill_cache_step(params, batch) -> (first new token ids [B] int32,
    cache): the production prefill, which runs the prompt forward and
    writes the decode cache for ``cache_len`` positions."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill_cache_step(params, batch):
        x, cache = T.prefill_with_cache(
            params, cfg, {"tokens": batch["tokens"].to(dev)}, cache_len)
        return _greedy(params, cfg, x), cache

    return prefill_cache_step


def build_decode_step(cfg: ModelConfig, device="cuda", *,
                      context_parallel: bool = False,
                      shard_cache_seq: bool = False):
    """decode_step(params, cache, tokens, pos) -> (next-token ids [B] int32,
    cache): one greedy decode step; the cache is updated in place."""
    if context_parallel or shard_cache_seq:
        raise NotImplementedError(
            f"context_parallel / shard_cache_seq wait for {L.MESH_ITEM}")
    dev = resolve_device(device)

    @torch.inference_mode()
    def decode_step(params, cache, tokens, pos, enc_out=None):
        logits, cache = T.decode_step(params, cfg, cache, tokens.to(dev),
                                      pos, enc_out=enc_out)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return decode_step


# ---------------------------------------------------------------------------
# Live metrics: a pull endpoint over the in-memory recorder


def serve_metrics(recorder, host: str = "127.0.0.1", port: int = 0):
    """Serve a ``MemoryRecorder``'s latest snapshot as JSON over HTTP.

    ``GET /metrics`` (also ``/`` and ``/metrics/latest``) returns
    ``recorder.latest()``: the event count and the most recent manifest,
    round, eval and chunk events, so a long run driven with
    ``Experiment.run(recorder=...)`` can be watched from a second terminal:

        rec = obs.make("memory")
        server = serve_metrics(rec)          # port=0: the OS picks one
        host, port = server.server_address
        # ... e.run(n, recorder=rec) in the main thread ...
        # curl http://host:port/metrics

    The server runs ``serve_forever`` on a daemon thread and is returned
    (``server.server_address`` for the bound port, ``server.shutdown()`` to
    stop).  A request serializes only the latest events, never the whole
    log, so polling does not grow with the run.
    """
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/metrics",
                                             "/metrics/latest"):
                self.send_response(404)
                self.end_headers()
                return
            snap = recorder.latest() if hasattr(recorder, "latest") else {}
            body = json.dumps(snap, default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):    # keep the run's stdout clean
            pass

    server = HTTPServer((host, port), _Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="repro-obs-metrics")
    thread.start()
    return server
