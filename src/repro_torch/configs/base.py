"""Configuration schema (port of ``repro.configs.base``).

``ModelConfig`` is the frozen dataclass every module of the port consumes;
``FabricConfig``/``PortSpec`` describe the memory-movement fabric;
``ShapeConfig``/``SHAPES`` name the assigned input-shape cells and
``TrainConfig`` the optimizer and run settings of training.  Field
names, defaults and validation are the reference's, so a config built on
either side names the same model; only :attr:`ModelConfig.param_dtype`
returns a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PortSpec:
    """One logical stream attached to the fabric (an accelerator-side port).

    ``offset``/``words`` are the stream's extent on the packed burst's word
    axis (the per-port head/tail pointers of the paper's §III-C);
    ``gathered``/``pool_words`` mark a sparse-extent stream whose lines are
    named by a frame-index operand into a larger backing pool, and record
    the backing extent the gather-after-burst form would have moved."""
    name: str
    direction: str = "read"       # read | write
    lanes: int = 1                # W_acc multiplier for this stream
    offset: int = 0               # word-axis offset within the packed burst
    words: int = 0                # word-axis extent (0 = not yet scheduled)
    gathered: bool = False        # sparse extent: lines named by an index list
    pool_words: int = 0           # backing extent the gather indices address


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Parameters of the memory-movement fabric (paper §III design point).

    ``n_ports`` is N = W_line / W_acc, ``lane_width`` the per-port word
    width W_acc in elements.  ``impl`` selects the data-transfer network
    ("medusa" exchange network, the "crossbar" baseline, the "oracle"
    permute, or "fused": consumers contract against the line-major cache
    and KV traffic is never banked).  ``page_size`` is the KV-cache
    page in timesteps, ``pack`` the burst layout, ``word_fold`` the
    machine-word lane folding cap, ``paged_pool``/``fused_gather`` the
    serving engine's KV storage and where its page gather runs,
    ``pool_shards``/``collective`` the sharded pool's shard count and its
    exchange (``all_to_all`` or the ``ring`` of rotations).  The remaining
    fields are carried for parity with the reference config."""
    n_ports: int = 8
    lane_width: int = 64
    impl: str = "medusa"          # medusa | crossbar | oracle | fused
    tile: int = 0
    burst_len: int = 32
    page_size: int = 64
    pack: str = "packed"          # packed | pad
    word_fold: "str | int" = "auto"   # auto | 1 | 2 | 4
    paged_pool: bool = True       # serving engine: shared physical page pool
    fused_gather: "str | bool" = "auto"   # auto | True | False
    pool_shards: int = 1          # pool-axis shards over the device mesh
    collective: str = "all_to_all"    # all_to_all | ring
    preempt: str = "swap"         # swap | recompute | off
    swap_space_pages: int = 0     # host swap-space cap in pages (0 = unbounded)

    @property
    def line_width(self) -> int:
        """W_line: elements per DRAM line."""
        return self.n_ports * self.lane_width

    @property
    def fused_gather_on(self) -> bool:
        """Whether the paged gather/scatter is part of the fabric contract
        (sparse-extent bursts) rather than a consumer-side postprocess."""
        if self.fused_gather == "auto":
            return self.paged_pool
        return bool(self.fused_gather)

    def validate(self) -> "FabricConfig":
        if self.impl not in ("medusa", "crossbar", "oracle", "fused"):
            raise ValueError(f"unknown fabric impl {self.impl!r}")
        if self.pack not in ("packed", "pad"):
            raise ValueError(f"unknown burst packing {self.pack!r}")
        if self.word_fold not in ("auto", 1, 2, 4):
            raise ValueError(f"word_fold must be 'auto', 1, 2 or 4, "
                             f"got {self.word_fold!r}")
        if self.fused_gather not in ("auto", True, False):
            raise ValueError(f"fused_gather must be 'auto', True or False, "
                             f"got {self.fused_gather!r}")
        if self.pool_shards < 1:
            raise ValueError(f"pool_shards must be >= 1, "
                             f"got {self.pool_shards}")
        if self.collective not in ("all_to_all", "ring"):
            raise ValueError(f"collective must be 'all_to_all' or 'ring', "
                             f"got {self.collective!r}")
        if self.preempt not in ("swap", "recompute", "off"):
            raise ValueError(f"preempt must be 'swap', 'recompute' or 'off', "
                             f"got {self.preempt!r}")
        if self.swap_space_pages < 0:
            raise ValueError(f"swap_space_pages must be >= 0, "
                             f"got {self.swap_space_pages}")
        if self.n_ports < 1 or self.lane_width < 1:
            raise ValueError(f"bad fabric geometry N={self.n_ports} "
                             f"W_acc={self.lane_width}")
        if self.page_size < 1 or self.burst_len < 1:
            raise ValueError(f"bad fabric buffering page_size={self.page_size} "
                             f"burst_len={self.burst_len}")
        return self


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """A mixture-of-experts FFN: ``n_experts`` experts of width
    ``expert_d_ff``, top-``top_k`` routing with a static per-expert
    capacity of ``capacity_factor`` times the even share.  ``dispatch``
    names the reference's multi-device all-to-all schedule (``"xla"`` or
    the ``"medusa"`` ring); on one card it changes nothing.  ``pad_to``
    pads the expert axis with dead experts the router never selects."""
    n_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    dispatch: str = "xla"
    pad_to: int = 0

    @property
    def n_experts_padded(self) -> int:
        return max(self.pad_to, self.n_experts)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """A Mamba-2 (SSD) mixer: state width ``d_state``, heads of
    ``head_dim`` over an inner width of ``expand * d_model``, a causal
    conv of ``conv_width`` taps and the SSD chunk length ``chunk``."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """A Griffin recurrent block: the RG-LRU over ``lru_width`` channels
    (0 = ``d_model``) after a causal conv of ``conv_width`` taps, with the
    gate sharpness constant ``c``."""
    lru_width: int = 0
    conv_width: int = 4
    c: float = 8.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture; the fields and defaults are the reference's."""
    name: str
    family: str                   # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 → d_model // n_heads
    # 'A' full attention, 'L' sliding window, 'R' RG-LRU, 'M' Mamba-2
    block_pattern: str = "A"
    sliding_window: int = 0
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0
    norm: str = "rms"             # rms | ln
    mlp: str = "swiglu"           # swiglu | geglu | gelu
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder_layers: int = 0
    encoder_seq: int = 1500
    n_patches: int = 0
    dtype: str = "bfloat16"
    remat: str = "full"
    scan_layers: bool = True
    kv_layout: str = "medusa"     # medusa | crossbar | oracle | fused
    fabric: Optional[FabricConfig] = None
    serve_fsdp: bool = False
    spec_heads: int = 0
    sharding_profile: str = "tp_heads"
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_fabric(self) -> FabricConfig:
        """The fabric this model moves memory through.  An explicit
        ``fabric`` wins; otherwise each KV head is a port (N = n_kv_heads)
        and a port word is one head vector (W_acc = head_dim)."""
        if self.fabric is not None:
            return self.fabric.validate()
        return FabricConfig(
            n_ports=max(self.n_kv_heads, 1),
            lane_width=self.resolved_head_dim or 1,
            impl=self.kv_layout).validate()

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_types(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        reps = -(-self.n_layers // len(pat))
        return tuple((pat * reps)[: self.n_layers])

    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        q = self.d_model * self.n_heads * hd
        kv = 2 * self.d_model * self.n_kv_heads * hd
        o = self.n_heads * hd * self.d_model
        return q + kv + o

    def _mlp_params(self, d_ff: int) -> int:
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        return mult * self.d_model * d_ff

    def _ffn_params(self) -> int:
        if self.moe is None:
            return self._mlp_params(self.d_ff)
        return (self.moe.n_experts * self._mlp_params(self.moe.expert_d_ff)
                + self.d_model * self.moe.n_experts)

    def _rglru_params(self) -> int:
        w = (self.rglru.lru_width or self.d_model) if self.rglru \
            else self.d_model
        # in/out projections + conv + input and recurrence gates + lambda
        conv = w * self.rglru.conv_width if self.rglru else 0
        return 2 * self.d_model * w + conv + 2 * w * w + w

    def _mamba_params(self) -> int:
        s = self.ssm
        d_in = s.expand * self.d_model
        nh = d_in // s.head_dim
        in_p = self.d_model * (2 * d_in + 2 * s.d_state + nh)
        conv = s.conv_width * (d_in + 2 * s.d_state)
        return in_p + conv + d_in * self.d_model + nh + d_in

    def param_count(self) -> int:
        """Total parameter count (embeddings included once if tied), the
        reference's analytic count; an encoder-decoder config (whisper)
        adds its encoder layers and each decoder layer's cross-attention."""
        total = self.vocab_size * self.d_model * (
            1 if self.tie_embeddings else 2)
        mixer = {"A": self._attn_params, "L": self._attn_params,
                 "R": self._rglru_params, "M": self._mamba_params}
        for t in self.layer_types():
            total += mixer[t]() + 2 * self.d_model
            if t != "M":           # a Mamba block has no separate FFN
                total += self._ffn_params()
        if self.encoder_layers:
            total += self.encoder_layers * (self._attn_params()
                                            + self._mlp_params(self.d_ff)
                                            + 2 * self.d_model)
            total += self.n_layers * (self._attn_params() + self.d_model)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: the top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        idle = (self.moe.n_experts - self.moe.top_k) * self._mlp_params(
            self.moe.expert_d_ff)
        return self.param_count() - idle * sum(
            t != "M" for t in self.layer_types())


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / run-level configuration (the reference's fields and
    defaults).  ``zero1`` gives the optimizer state ZeRO-1 specs over the
    data axes (:func:`repro_torch.launch.steps.zero1_specs`); every rank
    shares one device, so the state stays whole.  ``grad_compression`` is
    read by neither package's train step, which averages the rank blocks
    exactly; ``repro_torch.parallel.dp_grad_mean(..., "int8")`` is the
    compressed mean."""
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    zero1: bool = True            # shard optimizer state over data axis
    grad_accum: int = 0           # microbatches per step; 0 = auto-fit HBM
    grad_compression: str = "none"  # none | int8
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    seed: int = 0
