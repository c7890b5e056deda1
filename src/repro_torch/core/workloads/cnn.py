"""Layer graphs for the paper's evaluation networks (SSV-A).

A copy of the JAX package's ``core/workloads/cnn.py``, which is JAX-free.

AlexNet, VGG16, DarkNet19, ResNet-18/34/50/101/152 at 224x224, 8-bit
weights/activations (1 byte/element), per-sample costs.

Linearization conventions (documented deviations):
* pooling is folded into the producing conv (its *transmitted* output and the
  downstream spatial size are post-pool; FLOPs are the conv's own),
* residual-shortcut projection convs are folded into the first conv of their
  block (adds FLOPs/weights; keeps the graph a chain, as the paper's Table I
  indexing assumes),
* ``halo_bytes`` is the per-split-boundary WSP overlap volume:
  (k-1) * width * in_ch bytes for a conv row-split,
* classifier FC layers are OFF by default (``include_fc=False``): a 37 MB
  AlexNet fc6 can never be buffered on-package (1 MiB weight buffer/chiplet,
  Table III), so -- like prior chiplet-scheduling work the paper builds on --
  the evaluated stacks are the convolutional trunks.  DarkNet19's conv
  classifier head is kept (it is a 1x1 conv).
"""
from __future__ import annotations

from ..graph import LayerGraph, LayerNode, chain

BYTES = 1  # int8


def conv(
    name: str,
    in_hw: int,
    in_ch: int,
    out_ch: int,
    k: int,
    stride: int = 1,
    pool: int = 1,
    extra_flops: float = 0.0,
    extra_weights: float = 0.0,
) -> tuple[LayerNode, int]:
    """Returns (node, spatial size seen by the next layer)."""
    out_hw = max(1, in_hw // stride)
    post_hw = max(1, out_hw // pool)
    macs = float(out_hw) ** 2 * out_ch * in_ch * k * k
    weights = float(in_ch) * out_ch * k * k * BYTES
    node = LayerNode(
        name=name,
        kind="conv",
        flops=2.0 * macs + extra_flops,
        weight_bytes=weights + extra_weights,
        in_bytes=float(in_hw) ** 2 * in_ch * BYTES,
        out_bytes=float(post_hw) ** 2 * out_ch * BYTES,
        halo_bytes=float(max(0, k - 1)) * in_hw * in_ch * BYTES,
        # WSP splits are row stripes (halo above is per row seam), so the
        # useful WSP parallelism is the OUTPUT ROW count, not pixel count.
        wsp_parallel=float(out_hw),
        isp_parallel=float(out_ch),
    )
    return node, post_hw


def fc(name: str, in_dim: int, out_dim: int) -> LayerNode:
    macs = float(in_dim) * out_dim
    return LayerNode(
        name=name,
        kind="fc",
        flops=2.0 * macs,
        weight_bytes=macs * BYTES,
        in_bytes=float(in_dim) * BYTES,
        out_bytes=float(out_dim) * BYTES,
        halo_bytes=0.0,
        wsp_parallel=1.0,            # a single sample's FC has no spatial dim
        isp_parallel=float(out_dim),
    )


def alexnet(include_fc: bool = False) -> LayerGraph:
    layers = []
    n, hw = conv("conv1", 224, 3, 96, 11, stride=4, pool=2); layers.append(n)
    n, hw = conv("conv2", hw, 96, 256, 5, pool=2); layers.append(n)
    n, hw = conv("conv3", hw, 256, 384, 3); layers.append(n)
    n, hw = conv("conv4", hw, 384, 384, 3); layers.append(n)
    n, hw = conv("conv5", hw, 384, 256, 3, pool=2); layers.append(n)
    if include_fc:
        layers.append(fc("fc6", hw * hw * 256, 4096))
        layers.append(fc("fc7", 4096, 4096))
        layers.append(fc("fc8", 4096, 1000))
    return chain("alexnet", layers)


def vgg16(include_fc: bool = False) -> LayerGraph:
    cfg = [
        (64, 2, True), (128, 2, True), (256, 3, True), (512, 3, True), (512, 3, True),
    ]
    layers, hw, in_ch, idx = [], 224, 3, 1
    for out_ch, reps, do_pool in cfg:
        for r in range(reps):
            n, hw = conv(
                f"conv{idx}", hw, in_ch, out_ch, 3,
                pool=2 if (do_pool and r == reps - 1) else 1,
            )
            layers.append(n)
            in_ch = out_ch
            idx += 1
    if include_fc:
        layers.append(fc("fc14", hw * hw * 512, 4096))
        layers.append(fc("fc15", 4096, 4096))
        layers.append(fc("fc16", 4096, 1000))
    return chain("vgg16", layers)


def darknet19() -> LayerGraph:
    layers, hw, in_ch, idx = [], 224, 3, 1

    def add(out_ch, k, pool=1):
        nonlocal hw, in_ch, idx
        n, hw = conv(f"conv{idx}", hw, in_ch, out_ch, k, pool=pool)
        layers.append(n)
        in_ch = out_ch
        idx += 1

    add(32, 3, pool=2)
    add(64, 3, pool=2)
    add(128, 3); add(64, 1); add(128, 3, pool=2)
    add(256, 3); add(128, 1); add(256, 3, pool=2)
    add(512, 3); add(256, 1); add(512, 3); add(256, 1); add(512, 3, pool=2)
    add(1024, 3); add(512, 1); add(1024, 3); add(512, 1); add(1024, 3)
    add(1000, 1)  # classifier conv + global average pool
    return chain("darknet19", layers)


def _resnet(name: str, block_cfg: list[int], bottleneck: bool, include_fc: bool = False) -> LayerGraph:
    layers = []
    n, hw = conv("conv1", 224, 3, 64, 7, stride=2, pool=2)
    layers.append(n)
    in_ch = 64
    widths = [64, 128, 256, 512]
    for stage, (reps, width) in enumerate(zip(block_cfg, widths)):
        out_ch = width * (4 if bottleneck else 1)
        for b in range(reps):
            stride = 2 if (stage > 0 and b == 0) else 1
            proj_f = proj_w = 0.0
            if b == 0 and (in_ch != out_ch or stride != 1):
                proj_hw = max(1, hw // stride)
                proj_f = 2.0 * float(proj_hw) ** 2 * out_ch * in_ch
                proj_w = float(in_ch) * out_ch * BYTES
            if bottleneck:
                n, hw2 = conv(f"s{stage}b{b}_c1", hw, in_ch, width, 1, stride=stride,
                              extra_flops=proj_f, extra_weights=proj_w)
                layers.append(n)
                n, hw2 = conv(f"s{stage}b{b}_c2", hw2, width, width, 3)
                layers.append(n)
                n, hw2 = conv(f"s{stage}b{b}_c3", hw2, width, out_ch, 1)
                layers.append(n)
            else:
                n, hw2 = conv(f"s{stage}b{b}_c1", hw, in_ch, width, 3, stride=stride,
                              extra_flops=proj_f, extra_weights=proj_w)
                layers.append(n)
                n, hw2 = conv(f"s{stage}b{b}_c2", hw2, width, out_ch, 3)
                layers.append(n)
            hw = hw2
            in_ch = out_ch
    if include_fc:
        layers.append(fc("fc", in_ch, 1000))
    return chain(name, layers)


def resnet18():
    return _resnet("resnet18", [2, 2, 2, 2], bottleneck=False)

def resnet34():
    return _resnet("resnet34", [3, 4, 6, 3], bottleneck=False)

def resnet50():
    return _resnet("resnet50", [3, 4, 6, 3], bottleneck=True)

def resnet101():
    return _resnet("resnet101", [3, 4, 23, 3], bottleneck=True)

def resnet152():
    return _resnet("resnet152", [3, 8, 36, 3], bottleneck=True)


CNN_WORKLOADS = {
    "alexnet": alexnet,
    "vgg16": vgg16,
    "darknet19": darknet19,
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}


def get_cnn(name: str) -> LayerGraph:
    return CNN_WORKLOADS[name]()
