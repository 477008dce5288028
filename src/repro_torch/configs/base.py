"""Config schema for the DPPF framework (PyTorch port).

A copy of ``src/repro/configs/base.py`` with the data unchanged: the port
imports nothing of the JAX package, and ``tests/test_torch_configs.py``
holds the two copies equal field for field.

A ``ModelConfig`` fully describes one of the assigned architectures; a
``MeshPlan`` describes how a model is laid out on the production mesh; an
``InputShape`` is one of the four assigned workload shapes.

All configs are plain frozen dataclasses so they hash, compare, and print
deterministically (used as cache keys by the dry-run harness).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

# Block kinds understood by models/transformer.py. A layer pattern is cycled
# over the depth of the network.
BLOCK_KINDS = (
    "attn",         # GQA attention + dense MLP
    "local_attn",   # sliding-window attention + dense MLP (gemma2 odd layers)
    "moe",          # GQA attention + mixture-of-experts MLP
    "mamba",        # Mamba2 (SSD) block
    "shared_attn",  # attention+MLP block with weights shared across positions
    "mlstm",        # xLSTM matrix-memory block
    "slstm",        # xLSTM scalar-memory block
)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    source: str = ""                # citation for the config

    # --- attention options ---------------------------------------------------
    qkv_bias: bool = False          # qwen2
    rope_theta: float = 10000.0
    sliding_window: int = 0         # window size for local_attn blocks
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    post_block_norm: bool = False   # gemma2 uses pre+post norms

    # --- layer pattern (cycled over n_layers) --------------------------------
    layer_pattern: Tuple[str, ...] = ("attn",)

    # --- MoE ------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False     # llama4-scout
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0              # 0 -> derived from expand*d_model/64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4

    # --- encoder-decoder -------------------------------------------------------
    n_enc_layers: int = 0           # >0 => enc-dec model (seamless)

    # --- modality frontend stub -----------------------------------------------
    # Number of precomputed prefix embeddings (image patches / audio frames)
    # prepended to the token sequence. The frontend itself is a STUB: the
    # input pipeline / input_specs() provides embeddings of shape
    # (batch, n_prefix, d_model) directly (see DESIGN.md).
    n_prefix: int = 0

    # --- misc -------------------------------------------------------------------
    remat: bool = False             # checkpoint each block (dry-run/prod on)
    # beyond-paper perf knobs (EXPERIMENTS.md §Perf)
    xlstm_chunk: int = 0            # >0: chunkwise-parallel mLSTM
    moe_combine_dtype: str = "float32"  # bf16 halves MoE dispatch collectives
    seq_shard_acts: bool = False    # sequence-parallel residual activations
    act: str = "silu"               # silu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"         # compute/weight dtype for full-size runs

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, (
            f"{self.name}: n_heads must be a multiple of n_kv_heads")
        for k in self.layer_pattern:
            assert k in BLOCK_KINDS, f"unknown block kind {k!r}"

    # Derived ------------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def block_kind(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def blocks(self) -> Tuple[str, ...]:
        return tuple(self.block_kind(i) for i in range(self.n_layers))

    @property
    def is_recurrent(self) -> bool:
        """True if the arch has a sub-quadratic (stateful) sequence mixer."""
        return any(k in ("mamba", "mlstm", "slstm") for k in self.blocks())

    @property
    def has_sliding_window(self) -> bool:
        return any(k == "local_attn" for k in self.blocks())

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        n_attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            n_attn += (nq + 2 * nkv) * hd
        n_mlp = 3 * d * f  # gated MLP
        n = 0
        for kind in self.blocks():
            if kind in ("attn", "local_attn"):
                n += n_attn + n_mlp + 2 * d
            elif kind == "moe":
                e = n_attn + 2 * d + d * self.n_experts  # attn + norms + router
                e += self.n_experts * 3 * d * f
                if self.shared_expert:
                    e += 3 * d * f
                n += e
            elif kind == "mamba":
                d_in = self.ssm_expand * d
                heads = self.ssm_heads or d_in // 64
                n += (d * (2 * d_in + 2 * self.ssm_state * 0 + heads)  # in_proj-ish
                      + 2 * d_in * self.ssm_state + d_in * d + d
                      + self.ssm_conv * d_in)
            elif kind == "shared_attn":
                pass  # counted once below
            elif kind in ("mlstm", "slstm"):
                d_in = self.ssm_expand * d
                n += 4 * d * d_in + d_in * d + 2 * d
        if "shared_attn" in self.blocks():
            n += n_attn + n_mlp + 2 * d
        n += self.vocab_size * d            # embedding
        if not self.tie_embeddings:
            n += d * self.vocab_size        # lm head
        n += d                              # final norm
        if self.n_enc_layers:
            n += self.n_enc_layers * (n_attn + n_mlp + 2 * d)
            n += self.n_layers * (n_attn + d)  # cross-attention in decoder
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_experts = self.n_experts - self.top_k - (1 if self.shared_expert else 0)
        n_moe_layers = sum(1 for k in self.blocks() if k == "moe")
        return self.param_count() - n_moe_layers * dense_experts * 3 * d * f


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test variant of the same family: 2 layers, d_model<=256,
    <=4 experts, tiny vocab. Shapes shrink; the block pattern is preserved."""
    changes = dict(
        name=cfg.name + "-smoke",
        # at least one full pattern cycle so every block kind is exercised
        n_layers=max(2, len(cfg.layer_pattern)),
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        # no capacity drops at smoke scale -> decode == teacher forcing
        capacity_factor=4.0 if cfg.n_experts else cfg.capacity_factor,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_heads=8 if cfg.ssm_state else 0,
        ssm_chunk=32,
        sliding_window=64 if cfg.sliding_window else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        n_prefix=8 if cfg.n_prefix else 0,
        dtype="float32",
    )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Mesh / parallelism plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshPlan:
    """How a workload maps onto mesh axes.

    worker_axes enumerate DPPF workers (each index holds a distinct model
    replica). model_axes are tensor-parallel within a worker. fsdp_axes
    (hierarchical-DPPF extension, see DESIGN.md) shard weight storage within
    a worker; GSPMD inserts the gathers.
    """
    worker_axes: Tuple[str, ...] = ("data",)
    model_axes: Tuple[str, ...] = ("model",)
    fsdp_axes: Tuple[str, ...] = ()
    seq_shard_acts: bool = False     # sequence-sharded activations (hillclimb)
    microbatch: int = 1              # grad-accumulation microbatches per local step
    remat: bool = True               # checkpoint each block in backward

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return self.worker_axes + self.fsdp_axes + self.model_axes


@dataclass(frozen=True)
class DPPFConfig:
    """Hyperparameters of the paper's algorithm (Alg. 1 + Eq. 5)."""
    alpha: float = 0.1          # pull strength
    lam: float = 0.5            # push strength lambda
    tau: int = 4                # communication period (local steps per round)
    lam_schedule: str = "increasing"   # fixed | increasing | decreasing (§C.2)
    consensus: str = "simple_avg"       # any repro.core.methods registry name
                                        # (simple_avg/dppf, easgd, lsgd,
                                        # mgrawa/grawa, hard, ddp, parle,
                                        # lpf_sgd, entropy_sgd)
    push: bool = True           # False => vanilla soft-consensus baseline
    exact_second_term: bool = False     # keep T2 (ablation §D.1)
    # communication-period schedule (train.clock.RoundClock): "fixed" keeps
    # tau constant; "qsr" adapts it to the cosine LR per the Quadratic
    # Synchronization Rule (Gu et al. 2024, paper §7.2)
    tau_schedule: str = "fixed"
    qsr_beta: float = 0.0       # QSR: tau_t = max(tau, floor((beta/eta)^2));
                                # >0 also opts into QSR when tau_schedule
                                # was left at "fixed" (legacy convention)
    eps: float = 1e-12          # norm guard
    # consensus execution engine: "tree" walks the stacked pytree (reference
    # path), "flat" runs every method on the persistent (R, n) flat view
    # (workers + aux state rows) via repro.core.engine.ConsensusEngine
    # (DESIGN.md §Consensus-engine)
    engine: str = "tree"
    # round-boundary overlap: "none" applies the consensus computed from
    # THIS round's post-local-step params (exact, the paper's Alg. 1);
    # "staleness1" applies the consensus computed from the PREVIOUS round's
    # snapshot, so the round's all-reduce hides behind the tau local steps;
    # "doublebuf" additionally stores that snapshot ROW-SHARDED and
    # dispatches its worker-row gather + partial-Gram psum in
    # ``overlap_chunks`` column chunks interleaved with the scan's local
    # steps, leaving only the coefficient math and the mix GEMM at the
    # round boundary; "staleness_k" generalizes doublebuf to a k-deep ring
    # of snapshots — round r applies the consensus of the round-(r-k)
    # snapshot, rounds 0..k-1 are exact-consensus pipeline fill, and the
    # sharded worker-row gather runs as a ppermute ring of R-1 single-row
    # hops (DESIGN.md §Overlap). Flat engine only.
    overlap: str = "none"
    # doublebuf/staleness_k: number of column chunks the mid-scan snapshot
    # gather + partial-Gram psum are split into (1 = one un-chunked
    # dispatch, bit-for-bit the staleness1 consensus; more chunks
    # interleave finer with the tau local steps — effective count is
    # capped by tau and by the local column count)
    overlap_chunks: int = 4
    # staleness_k: pipeline depth k — the snapshot ring holds k buffers and
    # the consensus applied after round r was computed from round r-k.
    # k=1 is the doublebuf recursion (and bit-for-bit staleness1 when
    # overlap_chunks=1). Ignored by the other overlap modes.
    staleness: int = 1
    # bounded-async elastic membership (staleness_k only): a per-row
    # participation mask rides the snapshot carry; an inactive worker row
    # keeps its params frozen and drops out of the consensus target
    # weights (the row-stochastic lowering renormalizes over active rows).
    # A row is forced back in after ``staleness`` consecutive misses
    # (bounded staleness) and rejoins with an EASGD-style catch-up pull of
    # strength ``elastic_catchup`` toward the active-fleet mean.
    elastic: bool = False
    elastic_catchup: float = 0.5

    def __post_init__(self):
        # ValueError, not assert: every check here guards a user-facing
        # config path and must survive python -O (a silently dropped check
        # would train with a misconfigured engine/schedule/overlap)
        if self.engine not in ("tree", "flat"):
            raise ValueError(f"unknown consensus engine {self.engine!r}")
        # registry lookup raises ValueError on an unknown method name; a
        # local import keeps configs importable without pulling torch at
        # module load
        from repro_torch.core.methods import get_method
        spec = get_method(self.consensus)
        if spec.requires_flat and self.engine != "flat":
            raise ValueError(
                f"consensus={self.consensus!r} requires engine='flat' "
                "(its push force is a flat-view vector stage)")
        if self.tau_schedule not in ("fixed", "qsr"):
            raise ValueError(f"unknown tau schedule {self.tau_schedule!r}")
        if self.tau_schedule == "qsr" and self.qsr_beta <= 0:
            raise ValueError("tau_schedule='qsr' needs qsr_beta > 0")
        if self.overlap not in ("none", "staleness1", "doublebuf",
                                "staleness_k"):
            raise ValueError(f"unknown overlap mode {self.overlap!r}")
        if self.overlap != "none" and self.engine != "flat":
            raise ValueError(
                f"overlap={self.overlap!r} requires engine='flat' (the "
                "stale consensus snapshot lives in the flat view)")
        if self.overlap_chunks < 1:
            raise ValueError(
                f"overlap_chunks must be >= 1, got {self.overlap_chunks}")
        if self.staleness < 1:
            raise ValueError(
                f"staleness must be >= 1, got {self.staleness}")
        if self.elastic and self.overlap != "staleness_k":
            raise ValueError(
                "elastic=True requires overlap='staleness_k' (the "
                "participation mask rides the snapshot ring carry)")
        if self.elastic and self.exact_second_term:
            raise ValueError(
                "elastic=True does not support exact_second_term (the "
                "masked lowering only covers coefficient stages)")
        if not 0.0 <= self.elastic_catchup <= 1.0:
            raise ValueError(
                f"elastic_catchup must be in [0, 1], got "
                f"{self.elastic_catchup}")

    def apply_tune_plan(self, plan) -> "DPPFConfig":
        """Graft an autotune ``TunePlan`` (dataclass or its ``to_dict()``
        JSON form) onto this config: tau, overlap mode/chunks/staleness
        from the searched point, ``tau_schedule`` pinned to "fixed" —
        autotune placed tau at the measured comm/compute crossover, and a
        QSR schedule would re-adapt it away from that point, so the
        combination is rejected. ``dataclasses.replace`` re-runs
        ``__post_init__``, surfacing engine/overlap conflicts between the
        plan and this config."""
        if self.tau_schedule == "qsr" or self.qsr_beta > 0:
            raise ValueError(
                "autotune picks a fixed tau from the measured comm/compute "
                "crossover; tau_schedule='qsr' would re-adapt it — drop "
                "qsr_beta / use tau_schedule='fixed' when tuning")
        if isinstance(plan, dict):
            chosen = plan["chosen"]
            tau, chunks = int(chosen["tau"]), int(chosen["overlap_chunks"])
            overlap = str(plan.get("overlap", "none"))
            staleness = int(plan.get("staleness", 1))
        else:
            tau, chunks = int(plan.chosen.tau), int(plan.chosen.overlap_chunks)
            overlap, staleness = plan.overlap, int(plan.staleness)
        return dataclasses.replace(
            self, tau=tau, overlap=overlap, overlap_chunks=chunks,
            staleness=staleness, tau_schedule="fixed")

    @property
    def valley_width(self) -> float:
        """Theorem 1 target: lim E||Delta+|| = lambda/alpha."""
        return self.lam / self.alpha
