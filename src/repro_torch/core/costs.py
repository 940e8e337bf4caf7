"""Differentiable complexity regularizers (paper Sec. 4.3), in torch
(``repro.core.costs``, every formula as written there).

Every cost model consumes the same structural description of the network — a
list of :class:`LayerGeom` records built by the model definition — plus the
current selection parameters, and returns a scalar differentiable cost.

Models:
  * size   (Eq. 9)       -- bytes of weight memory, hardware-agnostic
  * bitops (Sec. 5.5.2)  -- MACs * px * pw, hardware-agnostic latency proxy
  * mpic   (Eq. 10-11)   -- LUT-based cycles on the MPIC RISC-V core
  * ne16   (Sec. 4.3.3)  -- 3-term analytical cycles on the NE16 accelerator
  * tpu    (ours)        -- TPU-v5e roofline latency (max(MXU, HBM) per layer)

``C_in,eff`` (Eq. 9) is the *expected un-pruned* channel count of the
producer layer; pruning an output channel therefore also pays off in every
consumer layer.

Dispatch goes through the pluggable registry in
``repro_torch.api.cost_models``: each model above is registered by name
with a differentiable ``expected`` face (the functions here) and a
``discrete`` face (the ``*_discrete`` functions below) for deployment
reporting.  The ``tpu`` model is the JAX package's TPU-v5e roofline
formula, kept as a search target; its constants describe that chip, not
the card the port runs on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.core import mps

COST_MODELS = ("size", "bitops", "mpic", "ne16", "tpu")


@dataclasses.dataclass(frozen=True)
class LayerGeom:
    """Static geometry of one quantizable layer (conv or linear)."""
    name: str
    kind: str                      # "conv" | "dwconv" | "linear"
    cin: int
    cout: int
    kx: int = 1
    ky: int = 1
    out_h: int = 1
    out_w: int = 1
    gamma: str = ""                # key of this layer's gamma in the pytree
    in_gamma: Optional[str] = None  # producer's gamma key (for C_in_eff)
    in_delta: Optional[str] = None  # input activation's delta key

    @property
    def macs(self) -> float:
        cin = 1 if self.kind == "dwconv" else self.cin
        return float(self.kx * self.ky * cin * self.cout
                     * self.out_h * self.out_w)

    @property
    def n_weights(self) -> float:
        cin = 1 if self.kind == "dwconv" else self.cin
        return float(self.kx * self.ky * cin * self.cout)


def _c(v, dev) -> torch.Tensor:
    """A float32 scalar constant on ``dev``."""
    return torch.tensor(v, dtype=torch.float32, device=dev)


def _dev(gammas: dict):
    return next(iter(gammas.values())).device


def _ste_ceil(x: torch.Tensor) -> torch.Tensor:
    """ceil() with identity gradient (keeps HW-granularity steps in the
    forward cost while remaining trainable)."""
    return x + (torch.ceil(x) - x).detach()


def _group_count(count: torch.Tensor, group: float) -> torch.Tensor:
    """Number of `group`-sized HW channel groups for a soft channel count.
    Counts below half a channel round to zero groups (otherwise every
    precision pays one phantom PE group from numerically-tiny probs)."""
    return _ste_ceil(torch.clamp_min(count - 0.5, 0.0)
                     / _c(group, count.device))


def _cin_eff(geom: LayerGeom, gammas: dict, pw: tuple[int, ...],
             ctx: mps.SearchCtx) -> torch.Tensor:
    """Effective (expected non-pruned) input channel count."""
    if geom.kind == "dwconv":
        return _c(1.0, _dev(gammas))
    if geom.in_gamma is None or geom.in_gamma not in gammas:
        return _c(float(geom.cin), _dev(gammas))
    keep = mps.keep_probability(gammas[geom.in_gamma], pw, ctx)
    if keep.shape[0] == 1:      # layer-wise gamma: one row for all channels
        return keep[0] * float(geom.cin)
    return torch.sum(keep)


def _soft_channel_counts(geom: LayerGeom, gammas: dict,
                         pw: tuple[int, ...], ctx: mps.SearchCtx
                         ) -> torch.Tensor:
    """Expected number of output channels at each precision: (|P_W|,)."""
    probs = mps.gamma_probs(gammas[geom.gamma], ctx)  # (C_out, |P|)
    if probs.shape[0] == 1:     # layer-wise gamma
        return probs[0] * float(geom.cout)
    return torch.sum(probs, dim=0)


def _act_probs(geom: LayerGeom, deltas: dict, px: tuple[int, ...],
               ctx: mps.SearchCtx, dev=None) -> torch.Tensor:
    if geom.in_delta is None or geom.in_delta not in deltas:
        # fixed 8-bit activations
        one_hot = [1.0 if p == 8 else 0.0 for p in px]
        if not any(p == 8 for p in px):
            one_hot = [float(i == len(px) - 1) for i in range(len(px))]
        return torch.tensor(one_hot, dtype=torch.float32, device=dev)
    return mps.delta_probs(deltas[geom.in_delta], ctx)


# --------------------------------------------------------------------------
# size (Eq. 9)
# --------------------------------------------------------------------------

def size_cost(geom: LayerGeom, gammas: dict, deltas: dict,
              pw: tuple[int, ...], px: tuple[int, ...],
              ctx: mps.SearchCtx) -> torch.Tensor:
    """Expected model size contribution of one layer, in *bytes*."""
    probs = mps.gamma_probs(gammas[geom.gamma], ctx)          # (C, |P|)
    exp_bits = probs @ torch.tensor(pw, dtype=probs.dtype,
                                    device=probs.device)      # (C,)
    total_bits = torch.sum(exp_bits)
    if probs.shape[0] == 1:     # layer-wise gamma
        total_bits = total_bits * float(geom.cout)
    cin_eff = _cin_eff(geom, gammas, pw, ctx)
    k = float(geom.kx * geom.ky)
    cin_term = _c(1.0, probs.device) if geom.kind == "dwconv" else cin_eff
    return cin_term * k * total_bits / _c(8.0, probs.device)


# --------------------------------------------------------------------------
# bitops (hardware-agnostic latency proxy)
# --------------------------------------------------------------------------

def bitops_cost(geom: LayerGeom, gammas: dict, deltas: dict,
                pw: tuple[int, ...], px: tuple[int, ...],
                ctx: mps.SearchCtx) -> torch.Tensor:
    counts = _soft_channel_counts(geom, gammas, pw, ctx)      # (|P_W|,)
    aprobs = _act_probs(geom, deltas, px, ctx, counts.device)  # (|P_X|,)
    cin_eff = _cin_eff(geom, gammas, pw, ctx)
    spatial = float(geom.out_h * geom.out_w * geom.kx * geom.ky)
    pw_b = torch.tensor(pw, dtype=counts.dtype, device=counts.device)
    px_b = torch.tensor(px, dtype=counts.dtype, device=counts.device)
    exp_pw_ch = torch.sum(counts * pw_b)        # sum over channels of bits
    exp_px = torch.sum(aprobs * px_b)
    return spatial * cin_eff * exp_pw_ch * exp_px


# --------------------------------------------------------------------------
# MPIC (Eq. 10-11): LUT of MACs/cycle per (p_x, p_w)
# --------------------------------------------------------------------------
# Reconstructed from the MPIC description (Ottavi et al. 2020): the SIMD
# dot-product unit packs 32 bits of operands -> 32/max(px,pw) MACs/cycle for
# homogeneous precisions; mixed-precision pairs gain ~20% from the reduced
# fetch count. Values are MACs/cycle.

def _mpic_lut() -> dict[tuple[int, int], float]:
    lut = {}
    for a in (2, 4, 8, 16):
        for w in (2, 4, 8, 16):
            base = 32.0 / max(a, w)
            lut[(a, w)] = base * (1.2 if a != w else 1.0)
    # homogeneous baselines measured in the paper are slightly below ideal
    lut[(8, 8)] = 4.0
    lut[(4, 4)] = 8.0
    lut[(2, 2)] = 16.0
    lut[(16, 16)] = 2.0
    return lut

MPIC_LUT = _mpic_lut()
MPIC_FREQ_HZ = 250e6          # paper Sec. 4.3.2
MPIC_POWER_W = 5.385e-3       # derived from paper Table 3 (energy/latency)


def mpic_cost(geom: LayerGeom, gammas: dict, deltas: dict,
              pw: tuple[int, ...], px: tuple[int, ...],
              ctx: mps.SearchCtx) -> torch.Tensor:
    """Expected cycles on MPIC (Eq. 10)."""
    counts = _soft_channel_counts(geom, gammas, pw, ctx)
    aprobs = _act_probs(geom, deltas, px, ctx, counts.device)
    cin_eff = _cin_eff(geom, gammas, pw, ctx)
    spatial = float(geom.kx * geom.ky * geom.out_h * geom.out_w)
    total = _c(0.0, counts.device)
    for i, b_x in enumerate(px):
        for j, b_w in enumerate(pw):
            if b_w == 0:
                continue  # pruned channels execute no MACs
            macs = spatial * cin_eff * aprobs[i] * counts[j]
            total = total + macs / _c(MPIC_LUT[(b_x, b_w)], counts.device)
    return total


# --------------------------------------------------------------------------
# NE16 (Sec. 4.3.3): streamer + PE-matrix + store, 32-channel granularity
# --------------------------------------------------------------------------
NE16_STREAMER_BITS = 288.0    # weight-load bandwidth, bits/cycle
NE16_STORE_BITS = 64.0        # L1 store bandwidth, bits/cycle
NE16_PE_SPATIAL = 9.0         # 3x3 PEs, one output pixel each
NE16_PE_COUT = 32.0           # output channels per PE invocation
NE16_FREQ_HZ = 370e6          # GAP9 max frequency


def ne16_cost(geom: LayerGeom, gammas: dict, deltas: dict,
              pw: tuple[int, ...], px: tuple[int, ...],
              ctx: mps.SearchCtx) -> torch.Tensor:
    """Expected cycles on NE16.

    Three terms (paper Sec. 4.3.3): (i) weight streamer load, (ii) PE-matrix
    MAC time -- bit-serial in the weight precision, processing 3x3 output
    pixels x 32 output channels per invocation, (iii) L1 result store.
    The ceil() on channel groups is what makes <32-channel precision groups
    unprofitable (Fig. 8 discussion).
    """
    counts = _soft_channel_counts(geom, gammas, pw, ctx)      # (|P_W|,)
    cin_eff = _cin_eff(geom, gammas, pw, ctx)
    k = float(geom.kx * geom.ky)
    spatial_tiles = (math.ceil(geom.out_h / 3) * math.ceil(geom.out_w / 3))
    dev = counts.device
    load = _c(0.0, dev)
    mac = _c(0.0, dev)
    kept = _c(0.0, dev)
    for j, b_w in enumerate(pw):
        if b_w == 0:
            continue
        groups = _group_count(counts[j], NE16_PE_COUT)  # 32-channel step
        cin_term = _c(1.0, dev) if geom.kind == "dwconv" else cin_eff
        # (i) weights streamed once per spatial tile row of invocations
        load = load + cin_term * k * groups * NE16_PE_COUT * b_w \
            / _c(NE16_STREAMER_BITS, dev)
        # (ii) bit-serial MACs: cin*k^2*pw/8 cycles per 3x3x32 output tile
        mac = mac + spatial_tiles * groups * cin_term * k * b_w \
            / _c(8.0, dev)
        kept = kept + counts[j]
    store = float(geom.out_h * geom.out_w) * kept * 8.0 \
        / _c(NE16_STORE_BITS, dev)
    return load + mac + store


def mpic_cycles_discrete(geom: LayerGeom, channel_bits, cin_eff: float,
                         act_bits: int = 8) -> float:
    """Discrete (post-search) MPIC cycle count for a concrete assignment."""
    import numpy as np
    channel_bits = np.asarray(channel_bits)
    spatial = float(geom.kx * geom.ky * geom.out_h * geom.out_w)
    cin_term = 1.0 if geom.kind == "dwconv" else float(cin_eff)
    total = 0.0
    for b_w in sorted(set(int(b) for b in channel_bits)):
        if b_w == 0:
            continue
        n = int(np.sum(channel_bits == b_w))
        total += spatial * cin_term * n / MPIC_LUT[(act_bits, b_w)]
    return total


def ne16_cycles_discrete(geom: LayerGeom, channel_bits, cin_eff: float
                         ) -> float:
    """Discrete (post-search) NE16 cycle count for a concrete assignment.

    ``channel_bits``: int array (C_out,) of assigned precisions. Used by the
    post-search refinement step and the deployment benchmarks.
    """
    import numpy as np
    channel_bits = np.asarray(channel_bits)
    k = float(geom.kx * geom.ky)
    cin_term = 1.0 if geom.kind == "dwconv" else float(cin_eff)
    spatial_tiles = math.ceil(geom.out_h / 3) * math.ceil(geom.out_w / 3)
    load = mac = 0.0
    kept = int(np.sum(channel_bits > 0))
    for b_w in sorted(set(int(b) for b in channel_bits)):
        if b_w == 0:
            continue
        n = int(np.sum(channel_bits == b_w))
        groups = math.ceil(n / NE16_PE_COUT)
        load += cin_term * k * groups * NE16_PE_COUT * b_w / NE16_STREAMER_BITS
        mac += spatial_tiles * groups * cin_term * k * b_w / 8.0
    store = float(geom.out_h * geom.out_w) * kept * 8.0 / NE16_STORE_BITS
    return load + mac + store


# --------------------------------------------------------------------------
# TPU v5e (ours, Sec. 3 of DESIGN.md): max(MXU, HBM) per layer
# --------------------------------------------------------------------------
TPU_BF16_FLOPS = 197e12
TPU_INT8_OPS = 394e12
TPU_HBM_BPS = 819e9
TPU_LANE = 128.0              # channel-group granularity (cf. NE16's 32)


def tpu_cost(geom: LayerGeom, gammas: dict, deltas: dict,
             pw: tuple[int, ...], px: tuple[int, ...],
             ctx: mps.SearchCtx) -> torch.Tensor:
    """Expected seconds on one TPU v5e core.

    Sub-8-bit precisions do NOT speed up the MXU (int8 is the floor) but DO
    shrink HBM traffic; only pruning (0-bit) removes FLOPs. Channel groups
    round to the 128-lane width (STE-ceil), mirroring the paper's NE16
    32-channel granularity argument at TPU scale.
    """
    counts = _soft_channel_counts(geom, gammas, pw, ctx)
    cin_eff = _cin_eff(geom, gammas, pw, ctx)
    k = float(geom.kx * geom.ky)
    dev = counts.device
    cin_term = _c(1.0, dev) if geom.kind == "dwconv" else cin_eff
    spatial = float(geom.out_h * geom.out_w)
    compute_macs = _c(0.0, dev)
    weight_bits = _c(0.0, dev)
    for j, b_w in enumerate(pw):
        if b_w == 0:
            continue
        lanes = _group_count(counts[j], TPU_LANE) * TPU_LANE
        compute_macs = compute_macs + spatial * k * cin_term * lanes
        weight_bits = weight_bits + k * cin_term * lanes * b_w
    compute_s = 2.0 * compute_macs / _c(TPU_INT8_OPS, dev)
    mem_s = (weight_bits / _c(8.0, dev)) / _c(TPU_HBM_BPS, dev)
    return torch.maximum(compute_s, mem_s)


# --------------------------------------------------------------------------
# discrete (post-search) counterparts for size / bitops / tpu
# --------------------------------------------------------------------------

def size_bytes_discrete(geom: LayerGeom, channel_bits, cin_eff: float,
                        act_bits: int = 8) -> float:
    """Discrete Eq. 9 bytes of one layer for a concrete assignment."""
    import numpy as np
    cin_term = 1.0 if geom.kind == "dwconv" else float(cin_eff)
    return cin_term * float(geom.kx * geom.ky) \
        * float(np.sum(np.asarray(channel_bits))) / 8.0


def bitops_discrete(geom: LayerGeom, channel_bits, cin_eff: float,
                    act_bits: int = 8) -> float:
    """Discrete MACs * px * pw of one layer for a concrete assignment."""
    import numpy as np
    spatial = float(geom.out_h * geom.out_w * geom.kx * geom.ky)
    cin_term = 1.0 if geom.kind == "dwconv" else float(cin_eff)
    return spatial * cin_term * float(np.sum(np.asarray(channel_bits))) \
        * float(act_bits)


def tpu_seconds_discrete(geom: LayerGeom, channel_bits, cin_eff: float,
                         act_bits: int = 8) -> float:
    """Discrete TPU-v5e roofline seconds for a concrete assignment."""
    import numpy as np
    channel_bits = np.asarray(channel_bits)
    k = float(geom.kx * geom.ky)
    cin_term = 1.0 if geom.kind == "dwconv" else float(cin_eff)
    spatial = float(geom.out_h * geom.out_w)
    compute_macs = weight_bits = 0.0
    for b_w in sorted(set(int(b) for b in channel_bits)):
        if b_w == 0:
            continue
        n = int(np.sum(channel_bits == b_w))
        lanes = math.ceil(n / TPU_LANE) * TPU_LANE
        compute_macs += spatial * k * cin_term * lanes
        weight_bits += k * cin_term * lanes * b_w
    return max(2.0 * compute_macs / TPU_INT8_OPS,
               (weight_bits / 8.0) / TPU_HBM_BPS)


# --------------------------------------------------------------------------
# dispatch (via the pluggable registry in repro.api.cost_models)
# --------------------------------------------------------------------------

def total_cost(geoms: Sequence[LayerGeom], gammas: dict, deltas: dict,
               pw: tuple[int, ...], px: tuple[int, ...],
               ctx: mps.SearchCtx, model: str = "size") -> torch.Tensor:
    """Sum of the per-layer regularizer over the whole network.

    ``model`` is a registry name (or a CostModel instance); custom hardware
    models registered via ``repro_torch.api.cost_models`` resolve here
    without touching this module.
    """
    from repro_torch.api.cost_models import get_cost_model
    cm = get_cost_model(model)
    total = _c(0.0, _dev(gammas))
    for geom in geoms:
        total = total + cm.expected(geom, gammas, deltas, pw, px, ctx)
    return total
