"""ArchConfig -> PHAROS `Workload` extraction.

PHAROS models a task as an ordered chain of layers priced by their
dominant GEMM (paper §3.3). This module flattens an assigned LM
architecture into that chain so the DSE / schedulers / DES treat LM
inference (or a training microbatch) exactly like the paper's DNN
tasks: segments = consecutive layers, WCET from the exec model.

Modes
-----
- ``prefill``: one job = forward over (batch, seq) tokens.
- ``decode``:  one job = one new token per sequence with a ctx-long
  KV cache / state — attention layers become memory-bound cache sweeps,
  which is what makes decode-heavy tasksets collective/HBM-limited.
- ``train``:   forward + backward (3x forward FLOPs on GEMMs) for one
  microbatch.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.core.rt.task import LayerDesc, Workload

_BF16 = 2


def _gemm(name, M, K, N, kind="mlp", mult: float = 1.0) -> LayerDesc:
    """GEMM layer; ``mult`` scales flops+bytes (train bwd = 3x)."""
    return LayerDesc(
        name,
        M=M,
        K=K,
        N=N,
        kind=kind,
        flops=mult * 2.0 * M * K * N,
        bytes_rw=mult * _BF16 * (M * K + K * N + M * N),
    )


def _attn_layers(cfg: ArchConfig, M: int, S_ctx: int, mode: str, mult: float, i: int):
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    qkv_n = (h + 2 * kv) * hd
    out = [_gemm(f"l{i}_qkv", M, d, qkv_n, "attn_proj", mult)]
    if mode == "decode":
        # one query against an S_ctx KV cache: 2 GEMV sweeps per head;
        # traffic dominated by reading the cache once.
        flops = mult * 2.0 * 2.0 * M * h * hd * S_ctx
        byts = mult * _BF16 * 2.0 * M * kv * S_ctx * hd  # K+V cache read
        out.append(
            LayerDesc(
                f"l{i}_attn",
                M=M,
                K=h * hd,
                N=S_ctx,
                kind="attn_decode",
                flops=flops,
                bytes_rw=byts,
            )
        )
    else:
        # causal: average S/2 keys per query
        flops = mult * 2.0 * 2.0 * M * h * hd * (S_ctx / 2.0)
        byts = mult * _BF16 * (2 * M * (h * hd) + M * S_ctx)
        out.append(
            LayerDesc(
                f"l{i}_attn",
                M=M,
                K=h * hd,
                N=S_ctx,
                kind="attn",
                flops=flops,
                bytes_rw=byts,
            )
        )
    out.append(_gemm(f"l{i}_out", M, h * hd, d, "attn_proj", mult))
    return out


def _mamba_layers(cfg: ArchConfig, M: int, mult: float, i: int):
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.mamba_d_state
    dt_rank = max(1, d // 16)
    scan_flops = mult * 8.0 * M * di * ns  # elementwise recurrence ops
    return [
        _gemm(f"l{i}_in", M, d, 2 * di, "ssm_proj", mult),
        _gemm(f"l{i}_xproj", M, di, dt_rank + 2 * ns, "ssm_proj", mult),
        LayerDesc(
            f"l{i}_scan",
            M=M,
            K=di,
            N=ns,
            kind="scan",
            flops=scan_flops,
            bytes_rw=mult * 4.0 * (2 * M * di * ns),
        ),
        _gemm(f"l{i}_out", M, di, d, "ssm_proj", mult),
    ]


def _rwkv_layers(cfg: ArchConfig, M: int, mult: float, i: int):
    d = cfg.d_model
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_size
    scan_flops = mult * 4.0 * M * H * hd * hd  # state update + readout
    return [
        _gemm(f"l{i}_rkvg", M, d, 4 * d, "rwkv_proj", mult),
        LayerDesc(
            f"l{i}_wkv",
            M=M,
            K=d,
            N=hd,
            kind="scan",
            flops=scan_flops,
            bytes_rw=mult * 4.0 * 2 * M * d,
        ),
        _gemm(f"l{i}_out", M, d, d, "rwkv_proj", mult),
    ]


def _ffn_layers(cfg: ArchConfig, ffn: str, M: int, mult: float, i: int):
    d, f = cfg.d_model, cfg.d_ff
    n_up = 2 if cfg.mlp_type == "swiglu" else 1
    if ffn == "dense":
        return [
            _gemm(f"l{i}_up", M, d, n_up * f, "mlp", mult),
            _gemm(f"l{i}_dn", M, f, d, "mlp", mult),
        ]
    if ffn == "moe":
        Ma = M * cfg.top_k  # active-token rows through experts
        return [
            _gemm(f"l{i}_router", M, d, cfg.n_experts, "moe_router", mult),
            _gemm(f"l{i}_moe_up", Ma, d, n_up * f, "moe", mult),
            _gemm(f"l{i}_moe_dn", Ma, f, d, "moe", mult),
        ]
    # rwkv channel-mix
    return [
        _gemm(f"l{i}_cmix_up", M, d, f, "mlp", mult),
        _gemm(f"l{i}_cmix_dn", M, f, d, "mlp", mult),
    ]


def arch_workload(
    cfg: ArchConfig,
    batch: int,
    seq: int,
    mode: str = "prefill",
    include_head: bool = True,
) -> Workload:
    """Flatten ``cfg`` into the PHAROS layer chain for one job.

    ``mode='decode'`` prices one token/sequence against a ``seq``-long
    context; other modes price the full (batch, seq) block.
    """
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    mult = 3.0 if mode == "train" else 1.0
    M = batch if mode == "decode" else batch * seq
    layers: list[LayerDesc] = []
    for i, (mixer, ffn) in enumerate(cfg.layer_plan()):
        if mixer == "attn":
            layers += _attn_layers(cfg, M, seq, mode, mult, i)
        elif mixer == "mamba":
            layers += _mamba_layers(cfg, M, mult, i)
        else:
            layers += _rwkv_layers(cfg, M, mult, i)
        layers += _ffn_layers(cfg, ffn, M, mult, i)
    if include_head:
        layers.append(_gemm("lm_head", M, cfg.d_model, cfg.vocab, "head", mult))
    return Workload(f"{cfg.name}:{mode}", tuple(layers))
