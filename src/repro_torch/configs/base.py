"""Unified model/run configuration for every assigned architecture family
(the port of ``repro/configs/base.py``, field for field).

One frozen dataclass covers dense decoders (GQA / SWA / QKV-bias), MoE,
Mamba-attention hybrids, xLSTM stacks, encoder-decoder, and modality-stub
VLM/audio backbones.  Each ``configs/<arch>.py`` instantiates it with the
exact assigned numbers (cited).  ``dtype`` stays a string;
``repro_torch.models.layers.dtype_of`` maps it to a ``torch.dtype``.  The
fields that steer the JAX package's compiler or mesh (``remat``,
``unroll``, the sharding axes) are kept so that a config compares equal
across the two packages; the port's serving path reads none of them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- attention ---
    rope_theta: float = 10000.0
    qkv_bias: bool = False           # qwen2 uses QKV bias
    sliding_window: Optional[int] = None   # SWA window (h2o-danube / mistral-style)
    attn_logit_softcap: Optional[float] = None

    # --- MLP ---
    mlp_act: str = "silu"            # silu => SwiGLU; gelu => GeGLU

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # expert hidden size (d_ff is then unused/dense-layer size)
    moe_every: int = 1               # MoE MLP every n-th layer (jamba: 2), others dense MLP
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # --- hybrid (jamba): one attention layer every attn_period layers, rest Mamba ---
    attn_period: int = 0             # 0 => not hybrid
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: Optional[int] = None    # default ceil(d_model/16)
    mamba_chunk: int = 256                 # chunked-scan length (memory lever)
    # dtype of the selective-scan intermediates (da/dbu/h).  float32 is the
    # reference; bfloat16 halves the scan's HBM traffic (§Perf lever) at a
    # small state-precision cost (carry stays fp32 at chunk boundaries).
    mamba_scan_dtype: str = "float32"

    # --- xLSTM ---
    slstm_every: int = 0             # sLSTM block every n-th layer; others mLSTM. 0 => no xLSTM
    mlstm_chunk: int = 256           # chunkwise-parallel chunk length for mLSTM

    # --- encoder-decoder ---
    num_encoder_layers: int = 0      # >0 => encoder-decoder (seamless)

    # --- modality stub (the one sanctioned carve-out: frontend not built) ---
    modality: Optional[str] = None   # 'vision' (pixtral) | 'audio' (seamless)
    modal_embed_dim: int = 0         # dim of precomputed patch/frame embeddings
    num_modal_tokens: int = 1024     # patches/frames per example at train shape

    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    # q-chunk length for blockwise attention (memory roofline lever)
    attn_q_chunk: int = 512
    # vocab chunk: sequence-chunked cross-entropy (lever)
    loss_seq_chunk: int = 512
    # analysis mode: unroll every depth/chunk loop so XLA cost_analysis sees
    # the true op counts (scan bodies are otherwise counted ONCE —
    # EXPERIMENTS.md §Methodology).  Never used for the fits/compiles run.
    unroll: bool = False
    # ---- beyond-paper performance levers (EXPERIMENTS.md §Perf) ----
    # Megatron-style sequence parallelism: constrain the residual stream's
    # sequence dim to this mesh axis between blocks (activations stop being
    # replicated across the TP axis; per-layer all-reduces become
    # reduce-scatter + all-gather pairs).  None = paper-faithful baseline.
    seq_shard_activations: Optional[str] = None
    # decode KV-cache update: 'dynamic' (dynamic_update_slice; baseline) or
    # 'select' (masked full-cache write — GSPMD-friendly when the cache seq
    # dim is sharded across the mesh; trades one cache sweep of HBM traffic
    # for eliminating cross-shard gather/scatter of the whole cache).
    decode_cache_update: str = "dynamic"
    # remat policy for the depth scan: 'full' (recompute everything) or
    # 'dots' (save matmul outputs — trades activation memory for NOT
    # recomputing the TP collectives in the backward pass).
    remat_policy: str = "full"
    # decode: mesh axis that shards the KV-cache *sequence* dim (set by the
    # serve builder with shard_cache_seq).  decode_attention then pins the
    # flash-decoding sharding explicitly — q replicated (it is ~100 KB),
    # scores/softmax sharded over seq — because GSPMD's default is to keep q
    # head-sharded and all-gather the multi-GB cache instead.
    decode_cache_seq_axis: Optional[str] = None
    # Mamba-native parallelism: shard the D_inner (channel) dim of the
    # selective-scan intermediates over this mesh axis (the S6 recurrence is
    # diagonal over channels, so channel sharding is collective-free inside
    # the scan).  None = leave it to GSPMD propagation.
    mamba_shard_channels: Optional[str] = None
    # how many layers one scan "superblock" covers (hybrid period or pattern len)
    citation: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.attn_period and self.num_layers % self.attn_period != 0:
            raise ValueError("num_layers must be a multiple of attn_period")
        if self.slstm_every and self.num_layers % self.slstm_every != 0:
            raise ValueError("num_layers must be a multiple of slstm_every")
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        if self.mamba_dt_rank is None:
            object.__setattr__(self, "mamba_dt_rank", max(self.d_model // 16, 8))

    # ---- derived ----
    @property
    def is_hybrid(self) -> bool:
        return self.attn_period > 0

    @property
    def is_xlstm(self) -> bool:
        return self.slstm_every > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def block_pattern(self) -> Tuple[str, ...]:
        """Layer-type pattern of one scan superblock.

        Homogeneous stacks have a period-1 pattern; jamba has period
        ``attn_period`` (1 attention + (period-1) mamba, with MoE on every
        ``moe_every``-th layer); xLSTM has period ``slstm_every``.
        """
        if self.is_hybrid:
            pat = []
            for i in range(self.attn_period):
                # jamba places its attention layer mid-period (layer index 4 of 8);
                # we put it at position 0 of each superblock — same 1:7 ratio.
                kind = "attn" if i == 0 else "mamba"
                mlp = "moe" if (self.is_moe and i % self.moe_every == 1) else "dense"
                pat.append(f"{kind}+{mlp}")
            return tuple(pat)
        if self.is_xlstm:
            pat = ["mlstm"] * self.slstm_every
            pat[-1] = "slstm"
            return tuple(pat)
        mlp = "moe" if self.is_moe else "dense"
        return (f"attn+{mlp}",)

    @property
    def num_superblocks(self) -> int:
        return self.num_layers // len(self.block_pattern)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND rooflines."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.modality:
            total += self.modal_embed_dim * d
        for blk in self.block_pattern * self.num_superblocks:
            kind, _, mlp = blk.partition("+")
            if kind == "attn" or kind == "":
                total += d * (self.num_heads * hd) * 2 + d * (self.num_kv_heads * hd) * 2
            if kind == "mamba":
                di = self.mamba_d_inner
                total += d * 2 * di + di * self.mamba_d_conv \
                    + di * (self.mamba_dt_rank + 2 * self.mamba_d_state) \
                    + self.mamba_dt_rank * di + di * self.mamba_d_state + di + di * d
            if kind in ("mlstm", "slstm"):
                # up-proj (2x), qkv-ish projections, gates, down-proj (see models/xlstm.py)
                di = 2 * d
                total += d * 2 * di + 3 * di * di // max(self.num_heads, 1) + 4 * di + di * d
            if mlp == "dense":
                total += 3 * d * self.d_ff
            elif mlp == "moe":
                total += d * self.num_experts + 3 * d * self.moe_d_ff * self.num_experts
        if self.is_encoder_decoder:
            # encoder self-attn + dense mlp + decoder cross-attn
            enc = self.num_encoder_layers * (
                d * (self.num_heads * hd) * 2 + d * (self.num_kv_heads * hd) * 2
                + 3 * d * self.d_ff)
            xattn = self.num_layers * (
                d * (self.num_heads * hd) * 2 + d * (self.num_kv_heads * hd) * 2)
            total += enc + xattn
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only) — for 6·N_active·D."""
        if not self.is_moe:
            return self.param_count()
        full_moe = 3 * self.d_model * self.moe_d_ff * self.num_experts
        act_moe = 3 * self.d_model * self.moe_d_ff * self.experts_per_token
        n_moe_layers = sum(1 for b in self.block_pattern if b.endswith("moe")) \
            * self.num_superblocks
        return self.param_count() - n_moe_layers * (full_moe - act_moe)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned (seq_len, global_batch, kind) shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # 'train' | 'prefill' | 'decode'


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
