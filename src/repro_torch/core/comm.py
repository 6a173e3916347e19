"""Bytes-on-the-wire accounting (``repro.core.comm``, paper Tab. 1): what each
round ships on the parameter plane, summed over clients; and Tab. 1's
parameter counts (``adapter_upload_params``, ``backbone_param_count``,
``client_storage_params``), pure arithmetic on a config.

FedNano ships NanoAdapters up (plus the diagonal FIM) and the merged
adapters down; ``param_up_wire`` is what the upload transforms put on the
wire. The activation-plane fields (split execution's embeddings up and
their gradients down) are kept for the JAX package's schema; the engine
logs none, as the JAX engine does not either.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class RoundTraffic:
    round_idx: int
    param_up: int = 0        # bytes: adapters uploaded, summed over clients
    param_down: int = 0      # bytes: merged adapters broadcast
    fisher_up: int = 0       # bytes: diagonal FIM uploads (FedNano only)
    act_up: int = 0          # bytes: split activations client -> server
    act_down: int = 0        # bytes: gradient activations server -> client
    param_up_wire: int = 0   # bytes on the wire after upload transforms

    def to_dict(self) -> Dict[str, int]:
        """JSON-safe form (checkpoints keep the whole per-round log, so a
        resumed run's totals equal the uninterrupted run's byte for byte)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "RoundTraffic":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"RoundTraffic checkpoint entry carries unknown fields "
                             f"{sorted(unknown)}; the comm-log format has diverged")
        return cls(**d)


@dataclass
class CommLog:
    rounds: List[RoundTraffic] = field(default_factory=list)

    def log_round(self, r: RoundTraffic):
        self.rounds.append(r)

    def totals(self) -> Dict[str, int]:
        out = {"param_up": 0, "param_down": 0, "fisher_up": 0, "act_up": 0,
               "act_down": 0, "param_up_wire": 0}
        for r in self.rounds:
            for k in out:
                out[k] += getattr(r, k)
        return out

    def state_dict(self) -> List[Dict[str, int]]:
        return [r.to_dict() for r in self.rounds]

    @classmethod
    def from_state_dict(cls, rounds: List[Dict[str, int]]) -> "CommLog":
        return cls(rounds=[RoundTraffic.from_dict(d) for d in rounds])


def adapter_upload_params(cfg) -> int:
    """Trainable NanoAdapter parameters a client uploads per round."""
    return len(cfg.adapter.modalities) * 2 * cfg.d_model * cfg.adapter.rank


def backbone_param_count(cfg) -> int:
    """Analytic parameter count of the full backbone (no materialization)."""
    d, f, L, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    hd = cfg.resolved_head_dim
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    if cfg.qkv_bias:
        attn += cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd
    if cfg.act in ("swiglu", "geglu"):
        mlp = 3 * d * f
    else:
        mlp = 2 * d * f
    norms = 2 * d

    total = 0
    if cfg.family == "moe":
        m = cfg.moe
        experts = m.n_experts * 3 * d * f
        shared = 3 * d * m.shared_d_ff if m.shared_d_ff else 0
        router = d * m.n_experts
        total += L * (attn + experts + shared + router + norms)
    elif cfg.family == "ssm":
        s = cfg.ssm
        d_inner = s.expand * d
        H = d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.d_state
        in_proj = d * (2 * d_inner + 2 * s.d_state + H)
        block = in_proj + s.d_conv * conv_dim + conv_dim + 3 * H + d_inner + d_inner * d
        total += L * (block + d)
    elif cfg.family == "hybrid":
        dr = cfg.rglru.d_rnn or d
        rec = 2 * d * dr + cfg.rglru.conv_width * dr + dr + 2 * (dr * dr + dr) + dr * d + dr
        n_attn = L // 3
        n_rec = L - n_attn
        total += n_rec * (rec + mlp + norms) + n_attn * (attn + mlp + norms)
    else:  # dense / vlm / audio decoder
        total += L * (attn + mlp + norms)
        if cfg.family == "audio":
            # encoder layers + cross attention in decoder
            total += cfg.n_enc_layers * (attn + mlp + norms)
            total += L * (attn + d)  # cross-attn + its norm
            total += cfg.max_seq_len * d + cfg.enc_seq_len * d  # learned positions

    total += v * d  # embedding
    if not cfg.tie_embeddings:
        total += v * d
    total += d  # final norm
    if cfg.frontend_dim:
        total += cfg.frontend_dim * d + d  # connector
    return total


def client_storage_params(cfg, *, encoder_params: int | None = None) -> Dict[str, int]:
    """Tab. 1 'Client Params' decomposition for FedNano vs PEFT-FL.

    encoder_params: size of the stubbed frontend tower (defaults: CLIP
    ViT-L/14-336 ≈ 303.5M for vlm, whisper conv ≈ 7.4M for audio, 0 for text).
    """
    if encoder_params is None:
        encoder_params = {"vlm": 303_500_000, "audio": 7_400_000}.get(cfg.family, 0)
    connector = cfg.frontend_dim * cfg.d_model + cfg.d_model if cfg.frontend_dim else 0
    embedder = cfg.vocab_size * cfg.d_model
    adapters = adapter_upload_params(cfg)
    backbone = backbone_param_count(cfg)
    return {
        "encoder": encoder_params,
        "connector": connector,
        "token_embedder": embedder,
        "adapters": adapters,
        "fednano_client_total": encoder_params + connector + adapters,
        "fednano_client_total_with_embedder": encoder_params + connector + embedder + adapters,
        "backbone_total": backbone,
        "peft_client_total": backbone + encoder_params + connector,
        "uploads_fednano": adapters,
        "uploads_peft_rank64": _peft_adapter_params(cfg, rank=64),
    }


def _peft_adapter_params(cfg, rank: int) -> int:
    """Rank-64 LoRA on every linear projection of every layer (FedDPA-style:
    q, k, v, o + the 3 MLP matrices) — reproduces the paper's 180.89M
    (2.50 %) upload figure for LLaVA-1.5-7B within ~2 %."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    attn = (
        rank * (d + cfg.n_heads * hd)            # q
        + 2 * rank * (d + cfg.n_kv_heads * hd)   # k, v
        + rank * (cfg.n_heads * hd + d)          # o
    )
    n_mlp = 3 if cfg.act in ("swiglu", "geglu") else 2
    mlp = n_mlp * rank * (d + cfg.d_ff)
    n_layers = cfg.n_layers + (cfg.n_enc_layers or 0)
    return n_layers * (attn + mlp)
