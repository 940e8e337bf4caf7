"""Graph-interpreted CNNs: the paper's three reference networks, in torch
(``repro.models.cnn``).

A model is a tuple of :class:`Node` records executed in order.  The same
graph definition drives:
  * float training (warmup)            mode="float"
  * joint MPS + pruning search         mode="search"  (paper Sec. 4)
  * discretized quantized inference    mode="quant"   (after Eq. 7/8)
and produces the :class:`~repro_torch.core.costs.LayerGeom` records the
cost regularizers consume.  Parameters are nested dicts of tensors in the
JAX package's layout (OIHW weights, NHWC activations), so a tree crosses
between the packages leaf for leaf (``repro_torch.bridge``).

Reference architectures (sizes match the paper's Sec. 5.1 baselines):
  * resnet9   -- CIFAR-10, 9 conv layers, ~77.4k params (309.44 kB FP32)
  * dscnn     -- Google Speech Commands, ~22k params (88.06 kB FP32)
  * resnet18  -- Tiny ImageNet (200 classes), ~11.26M params (45.05 MB FP32)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import costs, mps, quantizers
from repro_torch.core import rng as trng
from repro_torch.nn import layers


@dataclasses.dataclass(frozen=True)
class Node:
    name: str
    kind: str                       # conv|dwconv|linear|add|maxpool|avgpool|gap|input
    inputs: tuple[str, ...] = ()
    cout: int = 0
    k: tuple[int, int] = (1, 1)
    stride: tuple[int, int] = (1, 1)
    pad: str = "SAME"
    act: str = "none"               # none | relu
    bn: bool = True
    gamma_group: str = ""           # shared selection-parameter group

    def group(self) -> str:
        return self.gamma_group or self.name


WEIGHT_KINDS = ("conv", "dwconv", "linear")


@dataclasses.dataclass(frozen=True)
class GraphDef:
    nodes: tuple[Node, ...]
    in_shape: tuple[int, int, int]      # (H, W, C)
    num_classes: int

    def weight_nodes(self):
        return [n for n in self.nodes if n.kind in WEIGHT_KINDS]

    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)


# ---------------------------------------------------------------------------
# shape/channel inference
# ---------------------------------------------------------------------------

def _trace_shapes(g: GraphDef):
    """Channel count and spatial (H, W) at every node output."""
    ch = {"input": g.in_shape[2]}
    hw = {"input": (g.in_shape[0], g.in_shape[1])}
    for n in g.nodes:
        if n.kind == "input":
            continue
        src = n.inputs[0]
        h, w = hw[src]
        if n.kind in ("conv", "dwconv"):
            sy, sx = n.stride
            if n.pad == "SAME":
                oh, ow = -(-h // sy), -(-w // sx)
            else:
                oh = (h - n.k[0]) // sy + 1
                ow = (w - n.k[1]) // sx + 1
            ch[n.name] = n.cout if n.kind == "conv" else ch[src]
            hw[n.name] = (oh, ow)
        elif n.kind == "linear":
            ch[n.name], hw[n.name] = n.cout, (1, 1)
        elif n.kind == "add":
            ch[n.name], hw[n.name] = ch[src], hw[src]
        elif n.kind in ("maxpool", "avgpool"):
            sy, sx = n.stride
            ch[n.name], hw[n.name] = ch[src], (h // sy, w // sx)
        elif n.kind == "gap":
            ch[n.name], hw[n.name] = ch[src], (1, 1)
        else:
            raise ValueError(n.kind)
    return ch, hw


def _producer_weight_node(g: GraphDef, name: str) -> Optional[Node]:
    """Nearest upstream weight node (through pools/gap; `add` returns one of
    the two producers -- they share a gamma group by construction)."""
    n = g.node(name) if name != "input" else None
    if n is None:
        return None
    if n.kind in WEIGHT_KINDS:
        return n
    return _producer_weight_node(g, n.inputs[0])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(g: GraphDef, key: torch.Tensor):
    """He-normal weights from a threefry key (``core/rng.py``), on the
    key's device; the key stream is the JAX package's."""
    ch, _ = _trace_shapes(g)
    dev = key.device
    params = {}
    for n in g.weight_nodes():
        key, sub = trng.split(key)
        cin = ch[n.inputs[0]]
        if n.kind == "conv":
            shape = (n.cout, cin, n.k[0], n.k[1])
            fan_in = cin * n.k[0] * n.k[1]
        elif n.kind == "dwconv":
            shape = (cin, 1, n.k[0], n.k[1])
            fan_in = n.k[0] * n.k[1]
        else:
            shape = (n.cout, cin)
            fan_in = cin
        p = {"w": layers.he_init(sub, shape, fan_in),
             "b": torch.zeros((shape[0],), dtype=torch.float32, device=dev)}
        if n.bn:
            p["bn"] = layers.bn_init(shape[0], dev)
        params[n.name] = p
    return params


def init_mps_params(g: GraphDef, pw: tuple[int, ...], px: tuple[int, ...],
                    layerwise: bool = False, device=None):
    """gamma per shared group, delta+alpha per weight node output.

    layerwise=True emulates EdMIPS-style per-layer precision assignment:
    a single gamma row per layer, broadcast over channels."""
    ch, _ = _trace_shapes(g)
    gammas, deltas, alphas = {}, {}, {}
    last = g.weight_nodes()[-1]
    for n in g.weight_nodes():
        grp = n.group()
        if grp not in gammas:
            c = 1 if layerwise else ch[n.name]
            gamma = mps.init_mps_weight(c, pw, device)
            if n.name == last.name and 0 in pw:
                # never prune the classifier's output channels -- they are
                # the classes (cf. paper Fig. 7: L_Out is never pruned)
                gamma[..., pw.index(0)] = -40.0
            gammas[grp] = gamma
        d, a = mps.init_mps_act(px, device=device)
        deltas[n.name] = d
        alphas[n.name] = a
    return {"gamma": gammas, "delta": deltas, "alpha": alphas}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return int(sum(np.prod(x.shape) for x in _leaves(params)))


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def apply(g: GraphDef, params, x, *, mode: str = "float", train: bool = False,
          mps_params=None, ctx: mps.SearchCtx | None = None,
          pw=(0, 2, 4, 8), px=(8,), assignment=None, folded: bool = False):
    """Run the graph. Returns (logits, new_params_with_bn_stats).

    mode="float" : plain float network (+BN when not folded)
    mode="search": effective weights/activations from the MPS parameters
    mode="quant" : discrete per-channel fake-quant at `assignment` bits
    """
    vals = {"input": x}
    new_params = dict(params)
    tag = 0
    for n in g.nodes:
        if n.kind == "input":
            continue
        src = vals[n.inputs[0]]
        if n.kind in WEIGHT_KINDS:
            tag += 1
            p = params[n.name]
            w = p["w"]
            if mode == "search":
                gamma = mps_params["gamma"][n.group()]
                w = mps.effective_weight(w, gamma, pw, ctx, 0, tag)
            elif mode == "quant":
                w = _assigned_quant_weight(w, assignment["gamma"][n.group()])
            if n.kind == "dwconv":
                out = layers.conv2d(src, w, p["b"], n.stride[0], n.pad,
                                    groups=src.shape[-1])
            elif n.kind == "conv":
                out = layers.conv2d(src, w, p["b"], n.stride[0], n.pad)
            else:
                if src.ndim > 2:
                    src = src.reshape(src.shape[0], -1)
                out = layers.linear(src, w, p["b"])
            if n.bn and not folded:
                out, new_bn = layers.batchnorm(out, p["bn"], train)
                if train:
                    np_ = dict(new_params[n.name])
                    np_["bn"] = new_bn
                    new_params[n.name] = np_
            # activation (float relu, or PACT-quantized in search/quant)
            if n.act == "relu":
                if mode == "float":
                    out = torch.relu(out)
                elif mode == "search":
                    out = mps.effective_activation(
                        out, mps_params["delta"][n.name],
                        mps_params["alpha"][n.name], px, ctx, tag)
                else:
                    # the plan's clip is a constant here, as in the
                    # reference, which closes over the assignment
                    out = quantizers.pact_quantize(
                        out, float(assignment["alpha"][n.name]),
                        assignment["delta"][n.name])
            vals[n.name] = out
        elif n.kind == "add":
            vals[n.name] = vals[n.inputs[0]] + vals[n.inputs[1]]
        elif n.kind == "maxpool":
            vals[n.name] = layers.max_pool(src, n.k[0], n.stride[0])
        elif n.kind == "avgpool":
            vals[n.name] = layers.avg_pool(src, n.k[0], n.stride[0])
        elif n.kind == "gap":
            vals[n.name] = layers.global_avg_pool(src)
        else:
            raise ValueError(n.kind)
    return vals[g.nodes[-1].name], new_params


def _assigned_quant_weight(w, channel_bits):
    """Discrete per-channel fake quantization at the assigned precisions."""
    channel_bits = torch.as_tensor(channel_bits, device=w.device)
    out = torch.zeros_like(w)
    for b in (2, 4, 8):
        mask = (channel_bits == b).reshape((-1,) + (1,) * (w.ndim - 1))
        out = out + torch.where(mask, quantizers.quantize_weights_symmetric(
            w, b, 0), torch.zeros((), dtype=w.dtype, device=w.device))
    return out  # 0-bit channels stay zero (pruned)


# ---------------------------------------------------------------------------
# BN folding (paper Sec. 4.2, before the search phase)
# ---------------------------------------------------------------------------

def fold_batchnorm(g: GraphDef, params):
    new = {}
    for n in g.weight_nodes():
        p = dict(params[n.name])
        if n.bn and "bn" in p:
            w, b = layers.fold_bn_into_conv(p["w"], p["b"], p["bn"])
            p = {"w": w, "b": b}
        new[n.name] = {"w": p["w"], "b": p["b"]}
    return new


# ---------------------------------------------------------------------------
# cost geometry extraction
# ---------------------------------------------------------------------------

def cost_geoms(g: GraphDef) -> list[costs.LayerGeom]:
    ch, hw = _trace_shapes(g)
    geoms = []
    for n in g.weight_nodes():
        prod = _producer_weight_node(g, n.inputs[0])
        oh, ow = hw[n.name]
        geoms.append(costs.LayerGeom(
            name=n.name,
            kind=n.kind if n.kind != "linear" else "linear",
            cin=ch[n.inputs[0]] if n.kind != "linear"
                else int(np.prod(hw[n.inputs[0]])) * ch[n.inputs[0]],
            cout=ch[n.name],
            kx=n.k[1], ky=n.k[0],
            out_h=oh, out_w=ow,
            gamma=n.group(),
            in_gamma=prod.group() if prod is not None else None,
            in_delta=prod.name if prod is not None else None,
        ))
    return geoms


# ---------------------------------------------------------------------------
# the three reference networks
# ---------------------------------------------------------------------------

def resnet9(num_classes: int = 10, in_shape=(32, 32, 3), width: int = 16
            ) -> GraphDef:
    """MLPerf-Tiny-style ResNet with 9 conv layers (paper CIFAR-10 net)."""
    w = width
    nodes = [Node("input", "input")]

    def conv(name, src, cout, k=3, s=1, act="relu", grp=""):
        nodes.append(Node(name, "conv", (src,), cout, (k, k), (s, s),
                          act=act, gamma_group=grp))
        return name

    conv("stem", "input", w)
    # stack 1 (no downsample, identity shortcut): the residual add makes
    # stem and c1b share one gamma group (reconvergent channels, Sec. 4.1)
    conv("s1a", "stem", w)
    conv("s1b", "s1a", w, act="none", grp="stem")
    nodes.append(Node("add1", "add", ("s1b", "stem")))
    # stack 2 (stride-2, 1x1 conv shortcut) -- shortcut + main share gammas
    conv("s2a", "add1", 2 * w, s=2)
    conv("s2b", "s2a", 2 * w, act="none", grp="blk2")
    conv("sc2", "add1", 2 * w, k=1, s=2, act="none", grp="blk2")
    nodes.append(Node("add2", "add", ("s2b", "sc2")))
    # stack 3
    conv("s3a", "add2", 4 * w, s=2)
    conv("s3b", "s3a", 4 * w, act="none", grp="blk3")
    conv("sc3", "add2", 4 * w, k=1, s=2, act="none", grp="blk3")
    nodes.append(Node("add3", "add", ("s3b", "sc3")))
    nodes.append(Node("gap", "gap", ("add3",)))
    nodes.append(Node("fc", "linear", ("gap",), num_classes, bn=False,
                      act="none"))
    return GraphDef(tuple(nodes), in_shape, num_classes)


def dscnn(num_classes: int = 12, in_shape=(49, 10, 1), width: int = 64
          ) -> GraphDef:
    """MLPerf-Tiny DS-CNN for keyword spotting (paper GSC net).

    Pointwise->depthwise gamma sharing (Sec. 4.1): each depthwise conv
    shares the selection parameters of the pointwise conv that feeds it.
    """
    w = width
    nodes = [Node("input", "input"),
             Node("stem", "conv", ("input",), w, (10, 4), (2, 2),
                  act="relu")]
    prev = "stem"
    prev_grp = "stem"
    for i in range(4):
        dw, pw_ = f"dw{i}", f"pw{i}"
        # depthwise filters are tied to the channels produced upstream
        nodes.append(Node(dw, "dwconv", (prev,), w, (3, 3), (1, 1),
                          act="relu", gamma_group=prev_grp))
        nodes.append(Node(pw_, "conv", (dw,), w, (1, 1), (1, 1), act="relu"))
        prev, prev_grp = pw_, pw_
    nodes.append(Node("gap", "gap", (prev,)))
    nodes.append(Node("fc", "linear", ("gap",), num_classes, bn=False))
    return GraphDef(tuple(nodes), in_shape, num_classes)


def resnet18(num_classes: int = 200, in_shape=(64, 64, 3)) -> GraphDef:
    """ResNet-18 with a 3x3 stem (paper Tiny ImageNet net, ~11.26M params)."""
    nodes = [Node("input", "input"),
             Node("stem", "conv", ("input",), 64, (3, 3), (1, 1),
                  act="relu")]
    prev = "stem"
    stream_grp = "stem"  # gamma group of the current residual stream
    for stage, (cout, blocks) in enumerate([(64, 2), (128, 2), (256, 2),
                                            (512, 2)]):
        for b in range(blocks):
            s = 2 if (stage > 0 and b == 0) else 1
            base = f"st{stage}b{b}"
            downsample = stage > 0 and b == 0
            # every conv feeding the residual add of one stream shares a
            # gamma group so pruned channels line up (paper Sec. 4.1)
            grp = base if downsample else stream_grp
            nodes.append(Node(base + "a", "conv", (prev,), cout, (3, 3),
                              (s, s), act="relu"))
            nodes.append(Node(base + "b", "conv", (base + "a",), cout,
                              (3, 3), (1, 1), act="none", gamma_group=grp))
            if downsample:
                nodes.append(Node(base + "sc", "conv", (prev,), cout, (1, 1),
                                  (s, s), act="none", gamma_group=grp))
                shortcut = base + "sc"
                stream_grp = grp
            else:
                shortcut = prev  # identity; same stream group by definition
            nodes.append(Node(base + "add", "add", (base + "b", shortcut)))
            prev = base + "add"
    nodes.append(Node("gap", "gap", (prev,)))
    nodes.append(Node("fc", "linear", ("gap",), num_classes, bn=False))
    return GraphDef(tuple(nodes), in_shape, num_classes)


CNN_BUILDERS = {"resnet9": resnet9, "dscnn": dscnn, "resnet18": resnet18}
