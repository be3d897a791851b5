"""Top-level model API of every zoo family -- dense, MoE, the Jamba
hybrid, xLSTM, the encoder-decoder and the vision-prefix model (the port
of ``repro/models/transformer.py``): init, prefill (hidden states, or
hidden states plus the decode cache) and single-token decode.

Params keep the reference's tree, ``{"emb", "blocks": tuple per pattern
position of dicts stacked over superblocks, "final_ln"}`` plus, for an
encoder-decoder, ``"encoder": {"blocks": (attn+dense stacked over the
encoder's layers,), "final_ln"}``, so weights carry across with a tree map
(``repro_torch.interop.model_params_from_jax``).  The modality frontends
are stubs, as in the reference: a batch carries precomputed embeddings,
``modal_embeds`` [B, S_img, E] put in front of the text for a vision model
and ``src_embeds`` [B, S_enc, E] for the encoder, each projected by
``emb.modal_proj``.
The reference's depth ``lax.scan`` is a Python loop over the superblock
index, each superblock checkpointed under ``cfg.remat`` where autograd
records (``cfg.remat_policy`` "dots" recomputes everything too: the port
keeps no matmul outputs, so both policies give the same numbers).  The
serving functions run under ``torch.inference_mode()`` (``forward_hidden``
only where autograd would not record).  ``forward_loss`` is the training
forward: the mean next-token NLL over ``chunked_softmax_xent`` plus the
MoE's aux losses, differentiable through the layers' training routes.

Tensor parallelism: every serving function takes ``tp`` (a
``distribution.tensor_parallel.RankContext``) and then runs one rank's
model on its shard of the parameters (``distribution.sharding.
shard_params``, or ``init_sharded_params``, which draws a model too large
for one card a leaf at a time and keeps the rank's shard).  An
encoder-decoder's encoder runs on the mesh as the decoder's attn+dense
blocks do (its output whole on every rank of a data row), and the xLSTM
cells on their rank's heads (``xlstm``).  ``forward_loss`` takes ``tp``
too: one rank's training forward, its folds differentiable; under FSDP
(``tp.fsdp_axis``) a superblock gathers its cut leaves at its entry, inside
its checkpoint, and the loss gathers ``unemb`` (``layers.unshard``).
``cfg.seq_shard_activations`` (the reference's sequence-parallel
placement hint for GSPMD) changes nothing here.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution import sharding as SH
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

PyTree = Any


def _at(tree, i: int):
    """Superblock ``i`` of a dict of stacked tensors."""
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, depth: int) -> list:
    """The ``depth`` superblocks of a dict of stacked tensors, as views
    (one ``unbind`` a leaf: under autograd its backward stacks the
    superblocks' gradients once, where indexing would add ``depth``
    full-size zero-padded gradients)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, depth) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(depth)]
    return list(torch.unbind(tree, 0))


def _stack(trees):
    """One dict of stacked tensors from a list of like dicts."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# init


def _stack_blocks(generator, cfg: ModelConfig, device, cut=None) -> tuple:
    """The decoder's blocks: a tuple (per pattern position) of dicts
    stacked over superblocks, drawn superblock by superblock in each
    position's turn."""
    return tuple(_stack([B.init_block(generator, cfg, kind, device, cut)
                         for _ in range(cfg.num_superblocks)])
                 for kind in cfg.block_pattern)


def _init_encoder(generator, cfg: ModelConfig, device, cut=None) -> Dict:
    """The encoder of an encoder-decoder: ``num_encoder_layers`` attn+dense
    blocks stacked as one pattern position, and its final norm."""
    blocks = [B.init_block(generator, cfg, "attn+dense", device, cut)
              for _ in range(cfg.num_encoder_layers)]
    return {"blocks": (_stack(blocks),),
            "final_ln": L.init_rmsnorm(cfg.d_model, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """Random parameters with the reference's shapes, scales and dtypes.

    Every normal is drawn in fp32 from ``generator`` on the generator's own
    device, then cast to ``cfg.dtype`` and moved to ``device``: a CUDA
    generator draws a full-size model's weights on the card in well under a
    second, where a CPU generator takes seconds per GB (``chip_smoke.py``
    draws h2o-danube-1.8b on ``torch.Generator(device="cuda")``).  The
    draws differ from the reference's threefry streams; the parity tests
    carry the reference's weights across instead."""
    p = {"emb": L.init_embeddings(generator, cfg, device),
         "blocks": _stack_blocks(generator, cfg, device),
         "final_ln": L.init_rmsnorm(cfg.d_model, device)}
    if cfg.is_encoder_decoder:
        p["encoder"] = _init_encoder(generator, cfg, device)
    return p


def init_sharded_params(cfg: ModelConfig, generator: torch.Generator, mesh,
                        rank: int, device="cuda",
                        fsdp_axis: Optional[str] = None) -> Dict:
    """Rank ``rank``'s shard of ``init_params(cfg, generator, device)``,
    bitwise (``distribution.sharding.shard_params`` of it, with
    ``fsdp_axis`` as given), drawn without the whole model: every leaf is
    drawn in ``init_params``'s order, one superblock's leaf at a time, and
    only the rank's shard of it is kept (as a copy), so the peak is one
    full leaf.  Serves a model whose weights do not fit one card
    (jamba-v0.1-52b: 103 GB in bf16)."""
    plan = SH.tp_plan(cfg, mesh.shape["model"])

    def cut(path: str, t: torch.Tensor) -> torch.Tensor:
        names = tuple(path.split("/"))
        spec = SH._spec_for(names[-1], names[:-1], t.dim(), "model", None)
        spec = SH.with_fsdp(names, SH.leaf_cut(
            names, SH.sanitize_spec(mesh, spec, t.shape), plan), cfg, mesh,
            fsdp_axis)
        if all(e is None for e in spec):
            return t
        return SH.cut_leaf(t, spec, mesh, rank,
                           halves=SH._halves(names)).clone()

    p = {"emb": L.init_embeddings(generator, cfg, device,
                                  lambda name, t: cut(f"emb/{name}", t)),
         "blocks": _stack_blocks(generator, cfg, device, cut),
         "final_ln": L.init_rmsnorm(cfg.d_model, device)}
    if cfg.is_encoder_decoder:
        p["encoder"] = _init_encoder(generator, cfg, device, cut)
    return p


# ---------------------------------------------------------------------------
# the depth loop


def _run_stack(blocks, cfg: ModelConfig, pattern, x: torch.Tensor, *,
               causal: bool = True, enc_out=None, cache_len: int = 0,
               impl: str = "auto", tp=None, scope=None):
    """Depth loop over the stack (the leading axis of ``blocks``' leaves:
    the superblocks, or the encoder's layers), each superblock
    checkpointed under ``cfg.remat`` where autograd records.  With
    ``cache_len > 0`` it also returns every block's decode cache (prefill
    handoff), stacked over superblocks -- the ``init_cache`` layout.
    With ``tp``, each superblock is a scope of the rank's collectives
    (``RankContext.scope``, keyed ``i``, or ``(scope, i)`` for another
    stack: the encoder's), so that a checkpoint's recompute finds the
    results of its superblock's collectives; under FSDP the superblock
    gathers its cut leaves first, inside its checkpoint."""
    depth = blocks[0]["ln1"]["scale"].shape[0]
    per = [_unstack(b, depth) for b in blocks]
    caches = [[] for _ in pattern]

    def superblock(x, aux, i):
        key = i if scope is None else (scope, i)
        with (tp.scope(key) if tp is not None
              else contextlib.nullcontext()):
            params = L.unshard(cfg, [p[i] for p in per], tp)
            for pos, kind in enumerate(pattern):
                x, a, c = B.apply_block(params[pos], cfg, kind, x,
                                        causal=causal, enc_out=enc_out,
                                        cache_len=cache_len, impl=impl,
                                        tp=tp)
                aux = aux + a
                if cache_len:
                    caches[pos].append(c)
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(depth):
        if cache_len:
            x, aux = superblock(x, aux, i)
        else:
            x, aux = L.remat(cfg.remat, superblock, x, aux, i)
    if cache_len:
        return x, aux, tuple(_stack(c) for c in caches)
    return x, aux


def _modal(params, embeds: torch.Tensor) -> torch.Tensor:
    """Stub modality embeddings [B, S, E] projected to [B, S, D] by
    ``modal_proj``, in the weights' dtype (the reference's product
    promotes mixed dtypes; the port casts the embeddings)."""
    w = params["emb"]["modal_proj"]
    return embeds.to(device=w.device, dtype=w.dtype) @ w


def _encode(params, cfg: ModelConfig, src_embeds: torch.Tensor, *,
            impl: str = "auto", tp=None) -> torch.Tensor:
    """The encoder over stub modality embeddings: src_embeds
    [B, S_enc, E] -> enc_out [B, S_enc, D] (projection, the non-causal
    attn+dense stack, the final norm); with ``tp`` one rank's encoder
    (``modal_proj`` whole, the blocks cut as the decoder's), its output
    whole."""
    x = _modal(params, src_embeds)
    x, _ = _run_stack(params["encoder"]["blocks"], cfg, ("attn+dense",), x,
                      causal=False, impl=impl, tp=tp, scope="encoder")
    return L.rmsnorm(params["encoder"]["final_ln"], x, cfg.norm_eps)


def _decoder_inputs(params, cfg: ModelConfig, batch: Dict, tp=None
                    ) -> torch.Tensor:
    """Embed the text tokens; a vision model puts its projected image
    embeddings (``batch["modal_embeds"]``) in front, so positions run
    0..S-1 over image and text together."""
    x = L.embed(params["emb"], cfg, batch["tokens"], tp)
    if cfg.modality == "vision":
        img = _modal(params, batch["modal_embeds"])
        x = torch.cat([img.to(x.dtype), x], dim=1)
    return x


def _encoder_out(params, cfg: ModelConfig, batch: Dict, impl: str,
                 tp=None):
    return (_encode(params, cfg, batch["src_embeds"], impl=impl, tp=tp)
            if cfg.is_encoder_decoder else None)


# ---------------------------------------------------------------------------
# training forward (full sequence -> mean NLL + aux)


def forward_loss(params, cfg: ModelConfig, batch: Dict, *, count=None,
                 impl: str = "auto", tp=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens [B,St], labels [B,St] (+ loss_mask [B,St],
    modal_embeds / src_embeds).  Returns (loss, {"nll", "aux"}), 0-d fp32:
    loss = nll + aux, nll the mean NLL over the mask (its count floored at
    1); a vision model's loss covers its text positions only.
    Differentiable: take the gradient with ``torch.autograd.grad`` of
    parameters that require grad (the layers then take their training
    routes).

    ``tp`` runs one rank's model on its shard of the parameters, as
    ``forward_hidden`` does, differentiable through the model axis's folds
    (``RankContext``: ``enter``/``fold``; the loss over a cut vocabulary
    folds its softmax, ``layers.xent_sums``), so the gradient of a
    replicated leaf is whole on every model rank.  With the batch's rows
    cut over ``data`` (``tp.batch_split``) the MoE's dispatch is the whole
    batch's and its aux the rank's share (``moe.moe_mlp``); ``count``
    replaces the batch's own mask count, so that the nll is the rank's
    share of the whole batch's mean (the mean train step passes the folded
    count).  Under FSDP the batch's rows are its data rank's, and the
    gradient of a leaf cut over ``data`` comes out folded and cut."""
    enc_out = _encoder_out(params, cfg, batch, impl, tp)
    x = _decoder_inputs(params, cfg, batch, tp)
    x, aux = _run_stack(params["blocks"], cfg, cfg.block_pattern, x,
                        causal=True, enc_out=enc_out, impl=impl, tp=tp)
    x = L.rmsnorm(params["final_ln"], x, cfg.norm_eps)
    if cfg.modality == "vision":
        x = x[:, -batch["tokens"].shape[1]:, :]
    emb = L.unshard(cfg, params["emb"], tp)
    nll, cnt = L.xent_sums(x, L.unembed_matrix(emb, cfg),
                           batch["labels"], cfg.loss_seq_chunk,
                           batch.get("loss_mask"), cfg.remat,
                           tp if L.cuts(cfg, tp, "vocab") else None)
    nll = nll / torch.clamp(cnt if count is None else count, min=1.0)
    return nll + aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# serving forward


def forward_hidden(params, cfg: ModelConfig, batch: Dict, *,
                   impl: str = "auto", tp=None) -> torch.Tensor:
    """Prefill: final hidden states [B,S,D] (no loss; S counts a vision
    model's image positions too).  ``impl`` forces the kernels' routes
    (``ops.flash_attention``, ``ops.selective_scan``).  Runs under
    ``torch.inference_mode()`` unless autograd would record through it (a
    parameter or input requiring grad), so that a caller can
    differentiate it."""
    with torch.inference_mode(not L.records(params, batch)):
        enc_out = _encoder_out(params, cfg, batch, impl, tp)
        x = _decoder_inputs(params, cfg, batch, tp)
        x, _ = _run_stack(params["blocks"], cfg, cfg.block_pattern, x,
                          causal=True, enc_out=enc_out, impl=impl, tp=tp)
        return L.rmsnorm(params["final_ln"], x, cfg.norm_eps)


@torch.inference_mode()
def prefill_with_cache(params, cfg: ModelConfig, batch: Dict,
                       cache_len: int, *, impl: str = "auto", tp=None
                       ) -> Tuple[torch.Tensor, PyTree]:
    """Serving prefill that also writes the decode cache: returns
    (hidden [B,S,D], cache) where the cache matches ``init_cache(cfg, B,
    cache_len)`` and decode continues at pos = S.  With ``tp`` the cache is
    the rank's: its kv heads (all of them where they are not cut) and its
    Mamba channels.  An encoder-decoder runs its encoder here and again
    in ``encode_for_decode``, as the reference does."""
    enc_out = _encoder_out(params, cfg, batch, impl, tp)
    x = _decoder_inputs(params, cfg, batch, tp)
    x, _, cache = _run_stack(params["blocks"], cfg, cfg.block_pattern, x,
                             causal=True, enc_out=enc_out,
                             cache_len=cache_len, impl=impl, tp=tp)
    return L.rmsnorm(params["final_ln"], x, cfg.norm_eps), cache


# ---------------------------------------------------------------------------
# decode


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               cp_shards: int = 1, device="cuda") -> PyTree:
    """Stacked decode cache: a tuple (per pattern position) of dicts whose
    tensors have leading axis num_superblocks (allocated on ``device``:
    decode writes into them in place).  ``cp_shards``: as
    ``blocks.init_block_cache``."""
    caches = []
    for kind in cfg.block_pattern:
        one = B.init_block_cache(cfg, kind, batch, max_len, cp_shards,
                                 device)
        caches.append({k: v.expand((cfg.num_superblocks,) + v.shape).clone()
                       for k, v in one.items()})
    return tuple(caches)


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor, pos,
                *, enc_out=None, axis_name: Optional[str] = None,
                shard_offset=None, tp=None) -> Tuple[torch.Tensor, PyTree]:
    """One decode step.  tokens: [B,1] int; pos: the current position (an
    int or a 0-d tensor).  Returns (logits [B, vocab] fp32, cache), the
    cache being the one given, updated in place at ``pos``'s slot.
    ``enc_out``: an encoder-decoder's ``encode_for_decode`` output, handed
    to every block (only an xattn block reads it).  With ``tp`` one rank's
    step on its shards (the logits whole, gathered over the vocabulary);
    ``axis_name``/``shard_offset``: the context-parallel cache
    (``layers.decode_attention``)."""
    x = L.embed(params["emb"], cfg, tokens, tp)
    pattern = cfg.block_pattern
    for i in range(cfg.num_superblocks):
        for p_idx, kind in enumerate(pattern):
            x, _ = B.apply_block_decode(_at(params["blocks"][p_idx], i), cfg,
                                        kind, x, _at(cache[p_idx], i), pos,
                                        enc_out=enc_out, axis_name=axis_name,
                                        shard_offset=shard_offset, tp=tp)
    x = L.rmsnorm(params["final_ln"], x, cfg.norm_eps)
    return L.logits(params["emb"], cfg, x[:, 0, :], tp), cache


@torch.inference_mode()
def encode_for_decode(params, cfg: ModelConfig, batch: Dict, *,
                      impl: str = "auto", tp=None):
    """The encoder pass run once before decoding an encoder-decoder
    (``batch["src_embeds"]``); None for any other model.  With ``tp`` one
    rank's pass on its shard, the output whole."""
    return _encoder_out(params, cfg, batch, impl, tp)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(param_count(v) for v in params)
    return params.numel()
