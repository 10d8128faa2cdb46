"""Skeleton recognition backbones: ST-GCN and 2s-AGCN, in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/stgcn.py (mmaction's
skeleton_gcn STGCN and AGCN), with the same config dataclasses and the
same graph (`build_partitioned_adjacency`, a copy of the JAX function:
the 'spatial' partition into identity, centripetal and centrifugal
subsets, normalized by the column degree, in the block einsum's
orientation A[k, target, source]).

State-dict keys are the mmaction checkpoints' that
cross_modal_video_engine_tpu.convert.torch_import reads (`convert_stgcn`,
`convert_agcn`), so those importers are the parity bridge:

* both backbones: the graph as the buffer `A` in the reference
  orientation A[k, source, target], `data_bn` (flax's BatchNorm over the
  V * C joint-channel pairs, index v * C + c);
* ST-GCN: `st_gcn_networks.{i}` with `gcn.conv` (a biased 1x1 Conv2d to
  K * out channels, channel k * out + c), `tcn.0` (BatchNorm), `tcn.2`
  (the (9, 1) temporal Conv2d), `tcn.3` (BatchNorm), `residual.{0,1}`
  (a strided 1x1 Conv2d and BatchNorm where the shape changes), and the
  learned edge masks `edge_importance.{i}` (ones at the init).  A mask
  multiplies the graph in the JAX block's orientation, A[k, target,
  source]: `convert_stgcn` swaps the graph's axes and hands the mask on
  as it is;
* 2s-AGCN: `agcn_networks.{i}` with `gcn.PA` (the learned graph offset,
  1e-6 at the init), `gcn.conv_{a,b,d}.{k}` (1x1 Conv2d), `gcn.bn`
  (scale 1e-6 at the init), `gcn.down.{0,1}`, `tcn.0` (Conv2d), `tcn.1`
  (BatchNorm) and `residual.{0,1}`.  Its graph is used as the reference
  orientation has it: the aggregation contracts over the source joint,
  the attention's softmax runs over the source axis, scaled by 1 /
  (inter * T).

Every BatchNorm is `layers.FlaxBatchNorm` (flax's momentum 0.9 and biased
running variance).  The blocks compute channels-first, (B, C, T, V); the
backbones take channels-last keypoints (B, T, V, C), as the JAX modules
do, and pool to (B, C).  Block 0 runs without its residual.

`SkeletonClassifier` runs the backbone on each person of (B, M, T, V, C)
and averages the pooled features over M before the head (STGCNHead's
num_person semantics), or takes (B, T, V, C) as one person.  Its head is
`cls_head.fc`, the reference's 1x1 Conv2d of shape (classes, C, 1, 1),
computed as the JAX I3DHead computes it: dropout, then the Dense.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.registry import BACKBONES
from .layers import Dropout, FlaxBatchNorm

# COCO-17 skeleton edges (joint pairs) as the default layout
COCO_EDGES = ((0, 1), (0, 2), (1, 3), (2, 4), (0, 5), (0, 6), (5, 7),
              (7, 9), (6, 8), (8, 10), (5, 11), (6, 12), (11, 13),
              (13, 15), (12, 14), (14, 16), (11, 12), (5, 6))

# NTU-RGB+D 25-joint layout (skeleton_gcn/utils/graph.py:107-119,
# 1-based list converted; center = joint 20, the spine)
NTU_EDGES = tuple((i - 1, j - 1) for i, j in
                  ((1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5),
                   (7, 6), (8, 7), (9, 21), (10, 9), (11, 10), (12, 11),
                   (13, 1), (14, 13), (15, 14), (16, 15), (17, 1),
                   (18, 17), (19, 18), (20, 19), (22, 23), (23, 8),
                   (24, 25), (25, 12)))

GRAPH_LAYOUTS = {
    "coco": (17, COCO_EDGES, 0),
    "ntu-rgb+d": (25, NTU_EDGES, 20),
}


def build_partitioned_adjacency(num_joints: int = 17,
                                edges: Tuple = COCO_EDGES,
                                center: int = 0,
                                layout: Optional[str] = None) -> np.ndarray:
    """(3, V, V) float32: identity / centripetal / centrifugal normalized
    subsets (the 'spatial' strategy), in the orientation A[k, target,
    source].  `layout` ('coco' | 'ntu-rgb+d') overrides (num_joints,
    edges, center) with the reference Graph's named layouts."""
    if layout is not None:
        num_joints, edges, center = GRAPH_LAYOUTS[layout]
    V = num_joints
    adj = np.eye(V)                   # hop-0 self links + hop-1 edges
    for a, b in edges:
        adj[a, b] = adj[b, a] = 1
    # hop distance to the center joint
    dist = np.full(V, 1e9)
    dist[center] = 0
    for _ in range(V):
        for a, b in edges:
            dist[a] = min(dist[a], dist[b] + 1)
            dist[b] = min(dist[b], dist[a] + 1)
    # normalize_digraph: norm[j, i] = adj[j, i] / in_deg(i), the COLUMN
    # degree (self-loop included)
    deg = adj.sum(0)
    norm_ref = adj / np.maximum(deg[None, :], 1)
    # the spatial partition over (j, i) in A_ref[source, target]: hop 0
    # -> subset 0, hop 1 from an equal or farther source -> 1, from a
    # closer one -> 2
    ref = np.zeros((3, V, V))
    for j in range(V):
        for i in range(V):
            if norm_ref[j, i] == 0:
                continue
            if j == i:
                ref[0, j, i] = norm_ref[j, i]
            elif dist[j] >= dist[i]:
                ref[1, j, i] = norm_ref[j, i]
            else:
                ref[2, j, i] = norm_ref[j, i]
    return np.transpose(ref, (0, 2, 1)).astype(np.float32)


def _graph(cfg) -> np.ndarray:
    """The config's graph in the block orientation of its family: ST-GCN's
    A[k, target, source], AGCN's A[k, source, target] (each config's
    `adjacency` is in its own block's orientation)."""
    if cfg.adjacency is not None:
        return np.asarray(cfg.adjacency, np.float32)
    return build_partitioned_adjacency(cfg.num_joints, layout=cfg.layout)


def reference_graph(cfg) -> np.ndarray:
    """The graph buffer `A` as the reference checkpoint stores it,
    A[k, source, target]."""
    A = _graph(cfg)
    if isinstance(cfg, STGCNConfig):
        return np.ascontiguousarray(np.swapaxes(A, 1, 2))
    return A


def _bn(c: int, device) -> FlaxBatchNorm:
    return FlaxBatchNorm(c, device=device)


def _tcn_conv(cin: int, cout: int, stride: int, kernel: int,
              device) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, (kernel, 1), (stride, 1), (kernel // 2, 0),
                     device=device)


class _Residual(nn.Sequential):
    """residual.0 (strided 1x1 Conv2d) and residual.1 (BatchNorm)."""

    def __init__(self, cin: int, cout: int, stride: int, device):
        super().__init__(nn.Conv2d(cin, cout, 1, (stride, 1), device=device),
                         _bn(cout, device))


class _GCN(nn.Module):
    def __init__(self, cin: int, cout: int, K: int, device):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout * K, 1, device=device)


class STGCNBlock(nn.Module):
    """gcn conv -> the graph mix -> [BN, ReLU, temporal conv, BN] +
    residual, then ReLU (mmaction backbones/stgcn.py:23-99)."""

    def __init__(self, cin: int, cout: int, K: int, stride: int = 1,
                 residual: bool = True, temporal_kernel: int = 9,
                 device=None):
        super().__init__()
        self.K, self.cout = K, cout
        self.gcn = _GCN(cin, cout, K, device)
        # tcn.1 (ReLU) and tcn.4 (Dropout) hold no weights
        self.tcn = nn.ModuleDict({
            "0": _bn(cout, device),
            "2": _tcn_conv(cout, cout, stride, temporal_kernel, device),
            "3": _bn(cout, device)})
        self.has_residual = residual
        self.residual = (_Residual(cin, cout, stride, device)
                         if residual and (stride != 1 or cin != cout)
                         else None)

    def forward(self, x: torch.Tensor, Aw: torch.Tensor) -> torch.Tensor:
        """x: (B, C, T, V); Aw: (K, V target, V source), the masked graph."""
        B, _, T, V = x.shape
        f = self.gcn.conv(x).reshape(B, self.K, self.cout, T, V)
        y = torch.einsum("bkctv,kwv->bctw", f, Aw)
        y = self.tcn["3"](self.tcn["2"](F.relu(self.tcn["0"](y))))
        if not self.has_residual:
            return F.relu(y)
        sc = x if self.residual is None else self.residual(x)
        return F.relu(y + sc)


class _AGCNUnit(nn.Module):
    """The adaptive graph conv unit (reference agcn.py:43-160): per subset
    k, the graph A_k + PA_k plus the attention graph
    softmax(theta(x)^T phi(x)), then conv_d; bn; the down path."""

    def __init__(self, cin: int, cout: int, K: int, V: int, device):
        super().__init__()
        inter = max(cout // 4, 1)
        self.inter = inter
        self.PA = nn.Parameter(torch.empty(K, V, V, device=device))
        self.conv_a = nn.ModuleList(nn.Conv2d(cin, inter, 1, device=device)
                                    for _ in range(K))
        self.conv_b = nn.ModuleList(nn.Conv2d(cin, inter, 1, device=device)
                                    for _ in range(K))
        self.conv_d = nn.ModuleList(nn.Conv2d(cin, cout, 1, device=device)
                                    for _ in range(K))
        self.bn = _bn(cout, device)
        self.bn.init_scale = 1e-6      # the gcn output starts near zero
        self.down = (nn.Sequential(nn.Conv2d(cin, cout, 1, device=device),
                                   _bn(cout, device))
                     if cin != cout else None)

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        """x: (B, C, T, V); A: (K, V source, V target)."""
        T = x.shape[2]
        A = A + self.PA
        y = None
        for k in range(A.shape[0]):
            a = self.conv_a[k](x)                          # (B, i, T, V)
            b = self.conv_b[k](x)
            att = torch.softmax(torch.einsum("bitv,bitw->bvw", a, b)
                                / (self.inter * T), dim=-2)
            agg = torch.einsum("bctv,bvw->bctw", x, att + A[k])
            z = self.conv_d[k](agg)
            y = z if y is None else y + z
        y = self.bn(y)
        sc = x if self.down is None else self.down(x)
        return F.relu(y + sc)


class AGCNBlock(nn.Module):
    def __init__(self, cin: int, cout: int, K: int, V: int, stride: int = 1,
                 residual: bool = True, temporal_kernel: int = 9,
                 device=None):
        super().__init__()
        self.gcn = _AGCNUnit(cin, cout, K, V, device)
        self.tcn = nn.Sequential(
            _tcn_conv(cout, cout, stride, temporal_kernel, device),
            _bn(cout, device))
        self.has_residual = residual
        self.residual = (_Residual(cin, cout, stride, device)
                         if residual and (stride != 1 or cin != cout)
                         else None)

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        t = self.tcn(self.gcn(x, A))
        if not self.has_residual:
            return F.relu(t)
        res = x if self.residual is None else self.residual(x)
        return F.relu(t + res)


@dataclasses.dataclass(frozen=True)
class STGCNConfig:
    num_joints: int = 17
    in_channels: int = 3             # (x, y, score)
    channels: Tuple[int, ...] = (64, 64, 128, 128, 256, 256)
    temporal_strides: Tuple[int, ...] = (1, 1, 2, 1, 2, 1)
    # a checkpoint's graph (A[k, target, source]) in place of the layout's
    adjacency: Optional[Tuple] = None
    layout: Optional[str] = None     # 'coco' | 'ntu-rgb+d' named graph


@dataclasses.dataclass(frozen=True)
class AGCNConfig:
    num_joints: int = 17
    in_channels: int = 3
    channels: Tuple[int, ...] = (64, 64, 64, 64, 128, 128, 128, 256, 256,
                                 256)
    temporal_strides: Tuple[int, ...] = (1, 1, 1, 1, 2, 1, 1, 2, 1, 1)
    # a checkpoint's graph (A[k, source, target], used as it is)
    adjacency: Optional[Tuple] = None
    layout: Optional[str] = None     # 'coco' | 'ntu-rgb+d' named graph


class _GraphBackbone(nn.Module):
    """data_bn, the blocks, and the (T, V) mean pool."""

    networks = ""

    def __init__(self, cfg, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.cfg = cfg
        A = torch.from_numpy(reference_graph(cfg))
        self.register_buffer("A", A.to(device))
        K, V = A.shape[0], A.shape[1]
        self.data_bn = _bn(V * cfg.in_channels, device)
        cin, blocks = cfg.in_channels, []
        for i, (c, s) in enumerate(zip(cfg.channels, cfg.temporal_strides)):
            blocks.append(self._block(cin, c, K, V, s, i > 0, device))
            cin = c
        setattr(self, self.networks, nn.ModuleList(blocks))
        self.feat_dim = cin
        self.eval()

    def init_extras(self) -> Dict[str, torch.Tensor]:
        """The entries the training init sets apart from the convs and
        BatchNorms: the graph."""
        return {"A": torch.from_numpy(reference_graph(self.cfg))}

    def _data_bn(self, keypoints: torch.Tensor) -> torch.Tensor:
        """(B, T, V, C) -> data_bn over the V * C pairs -> (B, C, T, V)."""
        B, T, V, C = keypoints.shape
        x = self.data_bn(keypoints.reshape(B, T, V * C).transpose(1, 2))
        return x.reshape(B, V, C, T).permute(0, 2, 3, 1)

    def forward(self, keypoints: torch.Tensor) -> torch.Tensor:
        """keypoints: (B, T, V, C) -> pooled feature (B, channels[-1])."""
        x = self._data_bn(keypoints)
        for i, block in enumerate(getattr(self, self.networks)):
            x = block(x, self._graph_of(i))
        return x.mean(dim=(2, 3))


@BACKBONES.register("STGCN")
class STGCN(_GraphBackbone):
    networks = "st_gcn_networks"

    def __init__(self, cfg: STGCNConfig, device=None):
        super().__init__(cfg, device)
        dev = self.A.device
        self.edge_importance = nn.ParameterList(
            nn.Parameter(torch.empty(self.A.shape, device=dev))
            for _ in cfg.channels)
        if dev.type != "meta":
            with torch.no_grad():
                for p in self.edge_importance:
                    p.fill_(1.0)

    @staticmethod
    def _block(cin, cout, K, V, stride, residual, device):
        return STGCNBlock(cin, cout, K, stride, residual, device=device)

    def _graph_of(self, i: int) -> torch.Tensor:
        # the JAX block's A[k, target, source] times the mask
        return self.A.transpose(1, 2) * self.edge_importance[i]

    def init_extras(self) -> Dict[str, torch.Tensor]:
        out = super().init_extras()
        for i, p in enumerate(self.edge_importance):
            out[f"edge_importance.{i}"] = torch.ones(p.shape)
        return out


@BACKBONES.register("AGCN")
class AGCN(_GraphBackbone):
    networks = "agcn_networks"

    @staticmethod
    def _block(cin, cout, K, V, stride, residual, device):
        return AGCNBlock(cin, cout, K, V, stride, residual, device=device)

    def _graph_of(self, i: int) -> torch.Tensor:
        return self.A

    def init_extras(self) -> Dict[str, torch.Tensor]:
        out = super().init_extras()
        for i, block in enumerate(self.agcn_networks):
            out[f"agcn_networks.{i}.gcn.PA"] = torch.full(
                block.gcn.PA.shape, 1e-6)
        return out


class SkeletonHead(nn.Module):
    """cls_head.fc, the reference's (classes, C, 1, 1) Conv2d, computed as
    the JAX I3DHead: dropout, then the Dense."""

    def __init__(self, in_channels: int, num_classes: int,
                 dropout_ratio: float = 0.0, device=None):
        super().__init__()
        self.dropout = Dropout(dropout_ratio)
        self.fc = nn.Conv2d(in_channels, num_classes, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.dropout(x), self.fc.weight.flatten(1),
                        self.fc.bias)


class SkeletonClassifier(nn.Module):
    """A GCN backbone and its head.  (B, M, T, V, C) keypoints: the
    backbone runs on every person, the pooled features average over M
    before the head (JAX models/stgcn.py:285-305, dropout 0.0 there);
    (B, T, V, C): one person (the JAX BackboneClassifier, dropout 0.5)."""

    def __init__(self, backbone: nn.Module, num_classes: int,
                 dropout_ratio: float = 0.0):
        super().__init__()
        self.backbone = backbone
        self.cls_head = SkeletonHead(backbone.feat_dim, num_classes,
                                     dropout_ratio, device=backbone.A.device)
        self.eval()

    def extract_feat(self, keypoints: torch.Tensor) -> torch.Tensor:
        if keypoints.dim() == 4:
            return self.backbone(keypoints)
        B, M = keypoints.shape[:2]
        feat = self.backbone(keypoints.reshape((B * M,)
                                               + keypoints.shape[2:]))
        return feat.view(B, M, -1).mean(dim=1)

    def forward(self, keypoints: torch.Tensor) -> torch.Tensor:
        """-> class scores (B, num_classes)."""
        return self.cls_head(self.extract_feat(keypoints))


def is_skeleton_model(model: nn.Module) -> bool:
    """A GCN backbone, or a SkeletonClassifier over one."""
    return isinstance(model, (_GraphBackbone, SkeletonClassifier))
