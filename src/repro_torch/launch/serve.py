"""Serving step builders (the port of ``repro/launch/serve.py``): prefill,
prefill that writes the decode cache, and single-token greedy decode, on
one card or on a ``(data, model)`` mesh of ranks.

Each builder takes ``cfg`` and a ``device`` (default ``"cuda"``; raises
without a card) and returns the step function; the steps run under
``torch.inference_mode()`` and move the batch to the device (the params
and the cache must be there already).  A batch holds ``tokens`` [B, S] and,
for the stub-frontend models, ``modal_embeds`` [B, S_img, E] (a vision
model: the image prefix, in front of the text, so the cache covers
S_img + S positions) or ``src_embeds`` [B, S_enc, E] (an encoder-decoder;
its decode steps take the encoder's output, ``enc_out =
transformer.encode_for_decode(params, cfg, batch)``).  ``serve_metrics`` serves a
``MemoryRecorder``'s latest events over HTTP, to watch a long FL run.

    prefill = build_prefill_cache_step(cfg, "cuda", cache_len=S + n)
    ids, cache = prefill(params, {"tokens": prompt})         # prompt [B, S]
    decode = build_decode_step(cfg, "cuda")
    for pos in range(S, S + n):
        ids, cache = decode(params, cache, ids[:, None], pos)

**On a mesh** (``mesh=``, a ``launch.mesh.ServingMesh``) a builder returns
``(step, place)``.  ``place(params, cache=None)`` cuts full params and a
full cache to the ranks this process runs (a list, one entry a rank: the
counterpart of the reference's ``in_shardings_fn`` and ``device_put``);
``transformer.init_sharded_params`` gives one rank's params without the
whole model.  The steps take and return such lists and whole token
batches: the batch is cut over ``data`` (on a mesh with a pod axis over
``("pod", "data")``, ``mesh.dp_axes``; where it divides), the model over
``model`` (``distribution.sharding.tp_plan``), and the next ids come back
whole.  An xLSTM's decode cache holds a rank's heads of each mLSTM's
``C``/``n`` and every sLSTM's whole state; an encoder-decoder's decode
steps take the encoder's output whole (``build_encode_step`` runs the
encoder on the mesh) and cut its rows with the batch's.  ``build_decode_step(context_parallel=True)`` cuts the cache's
sequence over ``data`` instead (every data rank takes the whole batch,
``shard_offset = d * cache_len / data``, the flash-decoding merge folded
over ``data``); ``shard_cache_seq=True`` cuts it over ``model`` where the
kv heads do not divide (``cfg.decode_cache_seq_axis = "model"``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distribution import sharding as sh
from repro_torch.distribution.tensor_parallel import run_ranks
from repro_torch.launch.mesh import DP, dp_axes
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _greedy(params, cfg: ModelConfig, hidden: torch.Tensor, tp=None
            ) -> torch.Tensor:
    """Next-token ids [B] int32 from the last position's hidden state
    (the lowest index of a tie, as ``argmax`` over the whole vocabulary)."""
    logits = L.logits(params["emb"], cfg, hidden[:, -1, :], tp)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _dp(mesh):
    """The axis the batch is cut over: ``data``, or ``("pod", "data")`` on
    a mesh with a pod axis."""
    return mesh.canonical(DP)


def _split_batch(mesh, b: int) -> bool:
    """Whether a batch of ``b`` rows is cut over the batch axis (else every
    rank runs all of it, as the reference's sanitized batch spec)."""
    n = mesh.axis_size(_dp(mesh))
    return n > 1 and b % n == 0


def _on(batch: dict, dev) -> dict:
    """The batch's tensors on the device."""
    return {k: v.to(dev) for k, v in batch.items()}


def _rows(batch, ctx, split: bool):
    """The rank's rows of a tensor or of every tensor of a batch dict (all
    of them unless ``split``); marks ``ctx`` with the cut, which the MoE's
    dispatch reads."""
    ctx.batch_split = split
    ctx.batch_axis = _dp(ctx.mesh)
    if isinstance(batch, dict):
        return {k: _rows(v, ctx, split) for k, v in batch.items()}
    if not split:
        return batch
    per = batch.shape[0] // ctx.size(ctx.batch_axis)
    i = ctx.coord(ctx.batch_axis)
    return batch[i * per:(i + 1) * per]


def _whole(ids: torch.Tensor, ctx, split: bool) -> torch.Tensor:
    """Every rank's ids along the batch axis, in rank order (the
    batch's)."""
    if not split:
        return ids
    return torch.cat(list(ctx.gather(ids, _dp(ctx.mesh)).unbind(0)))


def _place_params(cfg: ModelConfig, mesh):
    def place(params):
        by_m = {}
        for r in mesh.local_ranks:
            m = mesh.coords(r)[1]
            if m not in by_m:
                by_m[m] = sh.shard_params(params, mesh, m, cfg)
        return [by_m[mesh.coords(r)[1]] for r in mesh.local_ranks]
    return place


def _decode_cache_specs(cfg: ModelConfig, mesh, cache_like, *,
                       context_parallel: bool = False,
                       seq_axis: Optional[str] = None):
    """The cut of a full decode cache on ``mesh`` (sanitized specs): batch
    over ``data`` and kv heads over ``model`` (where they divide), the
    Mamba state's channels over ``model``; the k/v sequence over ``data``
    for context-parallel decode, or over ``seq_axis`` with the heads
    whole."""
    if context_parallel:
        specs = sh.cache_specs(cache_like, batch_axes=(), model_axis="model",
                               num_kv_heads=cfg.num_kv_heads,
                               model_size=mesh.model, seq_axis="data")
    else:
        specs = sh.cache_specs(cache_like, batch_axes=dp_axes(mesh),
                               model_axis="model",
                               num_kv_heads=cfg.num_kv_heads,
                               model_size=mesh.model)
        if seq_axis:      # the reference's _reshard_kv_seq
            specs = sh._map_named(
                lambda names, sp: (sh.Spec(None, dp_axes(mesh), seq_axis,
                                           None, None)
                                   if len(sp) == 5 else sp),
                specs)
    if cfg.is_xlstm:
        specs = sh._map_named(
            lambda names, sp: _xlstm_cache_spec(cfg, mesh, names[-1], sp),
            specs)
    return sh.named_shardings(mesh, specs, cache_like)


def _xlstm_cache_spec(cfg: ModelConfig, mesh, name: str, spec):
    """The port's cut of an xLSTM cache leaf: an mLSTM's ``C``
    [n_sb,B,H,dh,dh] and ``n`` [n_sb,B,H,dh] by head over ``model`` where
    the plan cuts the cell (the rank's heads run; the reference's spec
    cuts a dh dim, which GSPMD may), every sLSTM state [n_sb,B,di] whole
    (every rank runs the whole recurrence); the batch as ``spec`` cuts
    it."""
    heads = "model" if sh.tp_plan(cfg, mesh.model).heads else None
    if name in ("C", "n") and len(spec) in (4, 5):    # the mLSTM's
        return sh.Spec(None, spec[1], heads, *([None] * (len(spec) - 3)))
    return sh.Spec(None, spec[1], None)


def build_prefill_step(cfg: ModelConfig, device="cuda", *, mesh=None):
    """prefill_step(params, batch) -> next-token ids [B] int32: the full
    forward over the prompt and a greedy first token (no cache).  With
    ``mesh``: ``(prefill_step, place)``."""
    dev = resolve_device(device)
    if mesh is None:
        @torch.inference_mode()
        def prefill_step(params, batch):
            x = T.forward_hidden(params, cfg, _on(batch, dev))
            return _greedy(params, cfg, x)
        return prefill_step

    @torch.inference_mode()
    def sharded_prefill_step(params, batch):
        batch = _on(batch, dev)
        split = _split_batch(mesh, batch["tokens"].shape[0])

        def program(ctx):
            p = params[ctx.index]
            x = T.forward_hidden(p, cfg, _rows(batch, ctx, split), tp=ctx)
            return _whole(_greedy(p, cfg, x, ctx), ctx, split)
        return run_ranks(mesh, program)[0]

    place = _place_params(cfg, mesh)
    return sharded_prefill_step, lambda params, cache=None: (place(params),
                                                             None)


def build_encode_step(cfg: ModelConfig, device="cuda", *, mesh=None):
    """encode_step(params, batch) -> enc_out [B, S_enc, D]: an
    encoder-decoder's encoder over ``batch["src_embeds"]``
    (``transformer.encode_for_decode``), the output its decode steps take.
    With ``mesh``: ``(encode_step, place)``, each rank's encoder on its
    shard and its data rank's rows, the output whole (the rows gathered
    over ``data``)."""
    dev = resolve_device(device)
    if mesh is None:
        @torch.inference_mode()
        def encode_step(params, batch):
            return T.encode_for_decode(params, cfg, _on(batch, dev))
        return encode_step

    @torch.inference_mode()
    def sharded_encode_step(params, batch):
        batch = _on(batch, dev)
        split = _split_batch(mesh, batch["src_embeds"].shape[0])

        def program(ctx):
            enc = T.encode_for_decode(params[ctx.index], cfg,
                                      _rows(batch, ctx, split), tp=ctx)
            return _whole(enc, ctx, split)
        return run_ranks(mesh, program)[0]

    place = _place_params(cfg, mesh)
    return sharded_encode_step, lambda params, cache=None: (place(params),
                                                            None)


def build_prefill_cache_step(cfg: ModelConfig, device="cuda", *,
                             cache_len: int, mesh=None):
    """prefill_cache_step(params, batch) -> (first new token ids [B] int32,
    cache): the production prefill, which runs the prompt forward and
    writes the decode cache for ``cache_len`` positions.  With ``mesh``:
    ``(prefill_cache_step, place)``; the cache comes back one entry a rank,
    in the layout of ``build_decode_step(mesh=mesh)``'s default cut."""
    dev = resolve_device(device)
    if mesh is None:
        @torch.inference_mode()
        def prefill_cache_step(params, batch):
            x, cache = T.prefill_with_cache(params, cfg, _on(batch, dev),
                                            cache_len)
            return _greedy(params, cfg, x), cache
        return prefill_cache_step

    @torch.inference_mode()
    def sharded_prefill_cache_step(params, batch):
        batch = _on(batch, dev)
        split = _split_batch(mesh, batch["tokens"].shape[0])

        def program(ctx):
            p = params[ctx.index]
            x, cache = T.prefill_with_cache(p, cfg, _rows(batch, ctx, split),
                                            cache_len, tp=ctx)
            return _whole(_greedy(p, cfg, x, ctx), ctx, split), cache
        out = run_ranks(mesh, program)
        return out[0][0], [c for _, c in out]

    place = _place_params(cfg, mesh)
    return sharded_prefill_cache_step, lambda params, cache=None: (
        place(params), None)


def build_decode_step(cfg: ModelConfig, device="cuda", *,
                      context_parallel: bool = False,
                      shard_cache_seq: bool = False, cache_len: int = 0,
                      mesh=None):
    """decode_step(params, cache, tokens, pos, enc_out=None) -> (next-token
    ids [B] int32, cache): one greedy decode step; the cache is updated in
    place; ``enc_out`` is an encoder-decoder's encoder output.  With
    ``mesh``: ``(decode_step, place)``, ``place(params, cache)`` cutting
    full params and a full cache to the mesh's ranks.
    ``context_parallel`` and ``shard_cache_seq`` need a mesh (the module
    docstring)."""
    dev = resolve_device(device)
    if mesh is None:
        if context_parallel or shard_cache_seq:
            raise ValueError("context_parallel / shard_cache_seq cut the "
                             "cache over a mesh: pass mesh= (a ServingMesh; "
                             "launch.mesh.make_host_mesh)")

        @torch.inference_mode()
        def decode_step(params, cache, tokens, pos, enc_out=None):
            logits, cache = T.decode_step(params, cfg, cache, tokens.to(dev),
                                          pos, enc_out=enc_out)
            return torch.argmax(logits, dim=-1).to(torch.int32), cache
        return decode_step

    if context_parallel and (cache_len <= 0 or cache_len % mesh.data):
        raise ValueError(f"context_parallel cuts the cache's {cache_len} "
                         f"slots over data = {mesh.data}: pass a cache_len "
                         "that it divides")
    seq_axis = None
    if (not context_parallel and shard_cache_seq
            and cfg.num_kv_heads % mesh.model != 0):
        seq_axis = "model"
        cfg = dataclasses.replace(cfg, decode_cache_seq_axis=seq_axis)

    @torch.inference_mode()
    def sharded_decode_step(params, cache, tokens, pos, enc_out=None):
        tokens = tokens.to(dev)
        split = not context_parallel and _split_batch(mesh, tokens.shape[0])

        def program(ctx):
            p, c = params[ctx.index], cache[ctx.index]
            toks = _rows(tokens, ctx, split)
            enc = None if enc_out is None else _rows(enc_out.to(dev), ctx,
                                                     split)
            if context_parallel:
                logits, c = T.decode_step(
                    p, cfg, c, toks, pos, enc_out=enc, axis_name="data",
                    shard_offset=ctx.d * (cache_len // mesh.data), tp=ctx)
            else:
                logits, c = T.decode_step(p, cfg, c, toks, pos,
                                          enc_out=enc, tp=ctx)
            ids = torch.argmax(logits, dim=-1).to(torch.int32)
            return _whole(ids, ctx, split), c
        out = run_ranks(mesh, program)
        return out[0][0], [c for _, c in out]

    place_params = _place_params(cfg, mesh)

    def place(params, cache=None):
        placed = None
        if cache is not None:
            specs = _decode_cache_specs(cfg, mesh, cache,
                                       context_parallel=context_parallel,
                                       seq_axis=seq_axis)
            placed = [sh.shard_cache(cache, mesh, r, specs)
                      for r in mesh.local_ranks]
        return place_params(params), placed

    return sharded_decode_step, place


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
