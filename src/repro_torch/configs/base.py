"""Model / run configuration. One ``<arch>.py`` per assigned architecture."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # attention
    attention: str = "gqa"       # gqa | mla
    qkv_bias: bool = False
    sliding_window: int = 0      # 0 = full attention
    rope_theta: float = 1e4

    # MLA (minicpm3-style latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 32

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # MoE layers at layer % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # the experts this device holds of each MoE layer under expert
    # parallelism: experts [expert_offset, expert_offset + experts_held);
    # 0 means all n_experts.  n_experts stays the published count: it sets
    # the router's width and the capacity
    experts_held: int = 0
    expert_offset: int = 0

    # hybrid (jamba): attention layers at layer % attn_every == attn_offset,
    # all other layers are Mamba blocks
    attn_every: int = 1          # 1 = all attention
    attn_offset: int = 0
    d_state: int = 16            # mamba state dim
    d_conv: int = 4
    mamba_expand: int = 2

    # ssm (xlstm): sLSTM layers at layer % slstm_every == slstm_offset
    slstm_every: int = 0         # 0 = no sLSTM (mLSTM everywhere)
    slstm_offset: int = 0

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500          # stubbed frame-embedding count

    # vlm
    n_vision_tokens: int = 0     # stubbed patch-embedding count

    # numerics / execution
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "block"         # none | block (checkpoint each layer block)
    attn_block_q: int = 512      # chunked-attention query block
    use_pallas: bool = False     # flip jnp reference -> Pallas kernels on TPU

    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.expert_offset + self.n_held > self.n_experts:
            raise ValueError(
                f"experts [{self.expert_offset}, {self.expert_offset + self.n_held}"
                f") are not among the {self.n_experts} experts")

    @property
    def n_held(self) -> int:
        """Experts held per MoE layer (``experts_held``, or all)."""
        return self.experts_held or self.n_experts

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def layer_kinds(self) -> list[str]:
        """Per-layer block kind: 'attn' | 'mamba' | 'mlstm' | 'slstm'."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                if self.slstm_every and i % self.slstm_every == self.slstm_offset:
                    kinds.append("slstm")
                else:
                    kinds.append("mlstm")
            elif self.attn_every > 1:
                kinds.append(
                    "attn" if i % self.attn_every == self.attn_offset else "mamba"
                )
            else:
                kinds.append("attn")
        return kinds

    def layer_is_moe(self, i: int) -> bool:
        if not self.n_experts:
            return False
        return i % self.moe_every == self.moe_offset

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for roofline;
        the experts counted are those held (``n_held``)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        d_inner = self.mamba_expand * d
        for i, kind in enumerate(self.layer_kinds()):
            if kind == "attn":
                if self.attention == "mla":
                    rq = self.q_lora_rank or d
                    rkv = self.kv_lora_rank
                    rd = self.rope_head_dim
                    total += d * rq + rq * h * (hd + rd)
                    total += d * rkv + rkv * h * (hd + hd) + d * rd
                    total += h * hd * d
                else:
                    total += d * (h + 2 * kv) * hd + h * hd * d
                    if self.qkv_bias:
                        total += (h + 2 * kv) * hd
            elif kind == "mamba":
                total += d * 2 * d_inner          # in_proj
                total += d_inner * self.d_conv    # conv
                total += d_inner * (self.d_state * 2 + 1)  # x_proj -> B,C,dt
                total += d_inner * self.d_state   # A
                total += d_inner * d              # out_proj
            elif kind in ("mlstm", "slstm"):
                total += d * 2 * d_inner          # up proj (x, z)
                total += 3 * d_inner * d_inner // max(self.n_heads, 1) * self.n_heads
                total += 3 * d_inner              # gates
                total += d_inner * d              # down proj
            if kind == "attn" or self.family != "ssm":
                if self.layer_is_moe(i):
                    total += self.n_held * 3 * d * ff + d * self.n_experts
                elif ff:
                    total += 3 * d * ff
        if self.is_encdec:
            # encoder self-attn + ffn + decoder cross-attn
            total += self.n_enc_layers * (4 * d * h * hd + 3 * d * ff)
            total += self.n_layers * (4 * d * h * hd)
        return int(total)

    def active_param_count(self) -> int:
        """Active (per-token) params: MoE counts top_k of n_experts."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        n_moe = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        dense_equiv = self.param_count() - n_moe * self.n_held * 3 * d * ff
        return int(dense_equiv + n_moe * max(self.top_k, 1) * 3 * d * ff)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment grid."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatches: int = 1
    grad_compression: bool = False    # int8 + error feedback on DP axis
    grad_wire_dtype: str = "float32"  # dtype of gradients crossing the
    #                                   DP reduction (bfloat16 halves the
    #                                   collective term; §Perf iteration)
    ckpt_every: int = 200
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep_ckpts: int = 3
    seed: int = 0
