"""Model + run configuration dataclasses (the framework's config system).

Every assigned architecture is one ``ModelConfig`` in ``configs/<id>.py``;
shapes (train_4k / prefill_32k / decode_32k / long_500k) live in
``configs/shapes.py``. ``--arch``/``--shape`` flags on the launchers select
them by name through :func:`repro.configs.registry`.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "ShapeConfig", "RunConfig"]


@dataclasses.dataclass(frozen=True)
class YarnScaling:
    """YaRN on the rotary part (arXiv:2309.00071), as DeepSeek-V3's code
    applies it at every length, under HF's ``rope_scaling`` names:
    frequencies past the correction range of ``beta_fast`` / ``beta_slow``
    rotations over ``original_max_position_embeddings`` positions divided
    by ``factor``, and the softmax scaled by mscale(factor,
    ``mscale_all_dim``)^2. Unequal ``mscale`` and ``mscale_all_dim`` would
    also scale the rotary sin and cos, which nothing here does: they
    raise."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float

    def __post_init__(self):
        if self.mscale != self.mscale_all_dim:
            raise ValueError(f"YaRN with mscale {self.mscale} != mscale_all_dim "
                             f"{self.mscale_all_dim} is not supported")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encoder | vlm | nemotron_h
                                 # | mla_moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0      # shared (always-on) experts
    moe_first_dense: int = 0     # leading dense layers in a MoE stack
    moe_dense_ff: int = 0        # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_impl: str = "gspmd"      # "gspmd" (pjit dispatch) | "a2a" (shard_map
                                 # all-to-all; needs a mesh with a model axis)
    # The single-mixer ``moe`` layers (``layer_pattern``'s E), sigmoid-routed
    # relu² experts (``models/moe.py`` ``moe_share_block``): the router
    # scores ``moe_router_experts`` experts (0 -> moe_num_experts), of which
    # the layer holds the first ``moe_num_experts`` (a chip's expert share).
    moe_router_experts: int = 0
    moe_routed_scale: float = 1.0  # routed experts' weights multiplied by it
    moe_shared_ff: int = 0       # shared experts' width (0 -> d_ff * moe_num_shared)
    moe_act: str = "relu2"       # those layers' experts: "relu2" (non-gated, nemotron-h's)
                                 # or "swiglu" (gate, up and down, DeepSeek-V3's)

    # --- multi-head latent attention (family "mla_moe": DeepSeek-V3's layout,
    # Kimi-K2): q from a latent of q_lora_rank, k and v from one of
    # kv_lora_rank, each RMS-normed; a head's q / k are qk_nope_head_dim
    # columns without rotary positions and qk_rope_head_dim with them (one
    # rotary key shared by every head), its v v_head_dim. 0: no MLA ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN on the rotary part (YarnScaling), or a dict of HF's
    # ``rope_scaling`` keys made into one; None leaves plain rotary positions
    rope_scaling: YarnScaling | None = None

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256         # SSD chunk length (perf knob, §Perf)
    attn_every: int = 0          # hybrid: shared attn block after every k blocks
    ssm_groups: int = 1          # groups of B and C, the heads split evenly over them
    ssm_heads: int = 0           # Mamba-2 heads (0 -> d_inner = ssm_expand * d_model)
    ssm_gated_norm: bool = False  # RMSNorm of y * silu(z) over each group's channels

    # --- a layout read from a pattern (nemotron_h): one letter a layer,
    # M a Mamba-2 layer, E a MoE layer, * an attention layer; the model is
    # its first ``num_layers`` letters (a pipeline stage 0 when fewer) ---
    layer_pattern: str = ""

    # --- xLSTM ---
    slstm_every: int = 0         # every k-th block is sLSTM (rest mLSTM)
    mlstm_proj_factor: float = 2.0

    # --- attention details ---
    causal: bool = True
    rope: bool = True            # False: no rotary positions (nemotron_h's attention)
    rope_theta: float = 10_000.0
    window: int = 0              # sliding-window size (0 = full attention)
    attn_shard: str = "heads"    # "heads" | "seq" (fallback when heads % tp != 0)
    attn_chunk: int = 1024       # online-softmax block size for long sequences
    attn_dense_threshold: int = 2048  # use chunked attention above this seq_len
    kv_cache_dtype: str = ""     # "" = compute dtype; "int8" = quantized cache
                                 # (per-token/head scales; halves decode HBM traffic)
    logit_softcap: float = 0.0

    # --- frontends (assignment: modality frontends are stubs) ---
    frontend: str = "none"       # none | patch (vlm) | frame (audio)
    frontend_dim: int = 0        # embedding dim of precomputed patch/frame inputs
    frontend_len: int = 0        # number of patch/frame positions per sample

    # --- numerics ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # --- notes for DESIGN/EXPERIMENTS ---
    source: str = ""

    def __post_init__(self):
        if isinstance(self.rope_scaling, dict):  # a configuration file's
            kw = dict(self.rope_scaling)
            if kw.pop("type", "yarn") != "yarn":
                raise ValueError(f"rope_scaling {self.rope_scaling} is not YaRN")
            object.__setattr__(self, "rope_scaling", YarnScaling(**kw))

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        if self.ssm_heads:
            return self.ssm_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def moe_routed(self) -> int:
        """Experts the router scores (a layer holds ``moe_num_experts`` of them)."""
        return self.moe_router_experts or self.moe_num_experts

    @property
    def moe_shared_width(self) -> int:
        return self.moe_shared_ff or self.d_ff * self.moe_num_shared

    # ------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Parameter count of the built model, exact for the attention
        kinds and for a ``layer_pattern`` layout (validated by tests). The
        ``attn_every`` hybrid's and xLSTM's are the reference's formulas,
        which leave out some per-channel leaves and count zamba2's shared
        block at every site."""
        d, v = self.d_model, self.vocab_size
        hd = self.head_dim_
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += d * v
        total += d  # final norm
        if self.frontend != "none":
            total += self.frontend_dim * d
        for kind in self.block_layout():
            total += self._block_params(kind, d, hd)
        return total

    def _mla_params(self, d):
        h, dn, dr = self.num_heads, self.qk_nope_head_dim, self.qk_rope_head_dim
        ql, kl = self.q_lora_rank, self.kv_lora_rank
        return (d * ql + ql + ql * h * (dn + dr) + d * (kl + dr) + kl
                + kl * h * (dn + self.v_head_dim) + h * self.v_head_dim * d)

    def _attn_params(self, d, hd):
        return d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) + (
            self.num_heads * hd
        ) * d

    def _block_params(self, kind, d, hd):
        if kind == "attn_mlp":
            return self._attn_params(d, hd) + 3 * d * self.d_ff + 2 * d
        if kind == "attn_dense_moe":  # leading dense layer inside a MoE model
            return self._attn_params(d, hd) + 3 * d * (self.moe_dense_ff or self.d_ff) + 2 * d
        if kind == "attn_moe":
            experts = self.moe_num_experts * 3 * d * self.d_ff
            shared = self.moe_num_shared * 3 * d * self.d_ff
            router = d * self.moe_num_experts
            return self._attn_params(d, hd) + experts + shared + router + 2 * d
        if kind in ("moe", "mla_moe"):  # relu² experts: up and down; SwiGLU: gate too
            mats = 3 if self.moe_act == "swiglu" else 2
            shared = mats * d * self.moe_shared_width if self.moe_num_shared else 0
            experts = d * self.moe_routed + self.moe_num_experts * mats * d * self.d_ff + shared
            if kind == "moe":
                return experts + d
            return self._mla_params(d) + experts + 2 * d
        if kind == "mla_dense":
            return self._mla_params(d) + 3 * d * (self.moe_dense_ff or self.d_ff) + 2 * d
        if kind == "attn":
            return self._attn_params(d, hd) + d
        if kind == "mamba2" and self.layer_pattern:
            di, n, g = self.d_inner, self.ssm_state, self.ssm_groups
            heads, conv_dim = di // self.ssm_head_dim, di + 2 * g * n
            norm = di if self.ssm_gated_norm else 0
            return (d * (2 * di + 2 * g * n + heads) + (self.ssm_conv + 1) * conv_dim
                    + 3 * heads + norm + di * d + d)
        if kind == "mamba2":
            di, n = self.d_inner, self.ssm_state
            heads = di // self.ssm_head_dim
            in_proj = d * (2 * di + 2 * n + heads)
            conv = (di + 2 * n) * self.ssm_conv
            extras = heads * 2 + di  # A_log, dt_bias, skip D
            out = di * d
            return in_proj + conv + extras + out + d
        if kind == "shared_attn":
            # one shared parameter set, counted once (returned by caller once)
            return self._attn_params(d, hd) + 3 * d * self.d_ff + 2 * d
        if kind == "mlstm":
            di = int(self.mlstm_proj_factor * d)
            qkv = 3 * di * di + 2 * di  # qkv + i,f gate biases folded in proj
            gates = 2 * di * 2  # per-channel i/f projections (low-rank-ish)
            return d * 2 * di + qkv + gates + di + di * d + d
        if kind == "slstm":
            h = d
            return 4 * (h * h + h * h + h) + d  # W, R (block-diag counted dense), b
        raise ValueError(kind)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top-k of routed). For
        ``moe`` layers that hold a share of the router's experts, the
        expected number of held experts a token reaches,
        ``top_k * held / routed``."""
        if not self.moe_num_experts:
            return self.param_count()
        total = self.param_count()
        d = self.d_model
        if self.layer_pattern or self.family == "mla_moe":
            expert = (3 if self.moe_act == "swiglu" else 2) * d * self.d_ff
            layers = sum(k in ("moe", "mla_moe") for k in self.block_layout())
            held = self.moe_num_experts
            active = expert * self.moe_top_k * held / self.moe_routed
            return int(total - layers * (held * expert - active))
        routed = (self.num_layers - self.moe_first_dense) * (
            self.moe_num_experts * 3 * d * self.d_ff
        )
        active_routed = routed * self.moe_top_k / self.moe_num_experts
        return int(total - routed + active_routed)

    # ------------------------------------------------------------- layout
    def block_layout(self) -> list[str]:
        """Per-layer block kinds, in order. 'shared_attn' appears at each
        application site but its params are shared (counted once)."""
        L = self.num_layers
        if self.layer_pattern:
            kinds = {"M": "mamba2", "E": "moe", "*": "attn"}
            if len(self.layer_pattern) < L or set(self.layer_pattern) - set(kinds):
                raise ValueError(f"layer_pattern {self.layer_pattern!r} must have at least {L} "
                                 f"letters of {sorted(kinds)}")
            return [kinds[c] for c in self.layer_pattern[:L]]
        if self.family in ("dense", "encoder", "vlm"):
            return ["attn_mlp"] * L
        if self.family == "moe":
            lead = ["attn_dense_moe"] * self.moe_first_dense
            return lead + ["attn_moe"] * (L - self.moe_first_dense)
        if self.family == "mla_moe":
            lead = ["mla_dense"] * self.moe_first_dense
            return lead + ["mla_moe"] * (L - self.moe_first_dense)
        if self.family == "hybrid":
            out = []
            for i in range(L):
                out.append("mamba2")
                if self.attn_every and (i + 1) % self.attn_every == 0:
                    out.append("shared_attn")
            return out
        if self.family == "ssm":
            out = []
            for i in range(L):
                if self.slstm_every and (i + 1) % self.slstm_every == 0:
                    out.append("slstm")
                else:
                    out.append("mlstm")
            return out
        raise ValueError(self.family)

    def segments(self) -> list[tuple[str, int]]:
        """Run-length encoding of block_layout -> scan segments."""
        out: list[tuple[str, int]] = []
        for kind in self.block_layout():
            if out and out[-1][0] == kind:
                out[-1] = (kind, out[-1][1] + 1)
            else:
                out.append((kind, 1))
        return out

    def supports_decode(self) -> bool:
        return self.family != "encoder"

    def supports_long_context(self) -> bool:
        """Sub-quadratic path exists (assignment: run long_500k only then)."""
        return self.family in ("hybrid", "ssm")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training-run knobs independent of the architecture."""

    optimizer: str = "adamw"        # adamw | adafactor | sgdm
    parallelism: str = "tp"         # "tp" (model axis = tensor parallel) |
                                    # "dp_only" (model axis = extra data parallel;
                                    # right-sizes small models on the fixed mesh)
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    remat: str = "dots"             # none | dots | full
    zero1: bool = True              # shard optimizer state over the data axis
    fsdp: bool = False              # shard params over the data axis too
    grad_allreduce_dtype: str = ""  # "" = native; "bfloat16" halves collective bytes
    microbatch: int = 0             # 0 = no gradient accumulation
    seq_parallel: bool = False      # Megatron-SP: shard residual stream on seq dim
    master_fp32: bool = True        # keep fp32 master weights in optimizer state
                                    # (False: update bf16 params directly — required
                                    # to fit kimi-k2-1t in 512 x 16 GB HBM)
