"""The rest of the MIL zoo (counterpart of vlsa_tpu/models/mil_ext.py):
TransMIL, ILRA, DeepAttnMISL and PatchGCN, the SA baselines of the paper's
tables.  Plain torch ops, f32 (float64 for a float64 model): none of them
reaches a Pallas kernel in vlsa_tpu.  Parameters keep vlsa_tpu's names, so
utils.weights maps its trees one to one; each is initialised from the
registry's seeded generator as vlsa_tpu initialises it (torch's Linear
bounds, xavier-uniform for `in_proj`, `latent` and `pool_seeds`, N(0, 1)
for `cls_token`, U(+-1/sqrt(k*k)) for PPEG's kernels, `t` = 1).  Dropout
(`train=True` only) draws from `layers.SeededDropout`.

- TransMIL: fc1, the padded length N squared up by repeating the leading
  tokens (with their mask), a cls token, Nyström layer, PPEG (depthwise
  7/5/3 convolutions on the square grid, no bias, as vlsa_tpu), Nyström
  layer, LayerNorm and fc2 on the cls token.  `ret_with_attn` adds the cls
  token's attention over the N patches, averaged over heads.
- ILRA: `num_layers` GABs (latent queries attend the bag with its mask; the
  bag attends them back unmasked), then `topk` seeds attend the bag.
  Each attention is vlsa_tpu's MultiHeadAttention: fc_q/k/v, then a
  separate `in_proj` [3d, d] and `out_proj` (torch's MultiheadAttention
  layout), residual, relu(fc_o), optional LayerNorms, a SiLU gate.
- DeepAttnMISL: per-cluster masked means of relu(phis(x)) (an empty cluster
  gives zeros; ids outside [0, K) count in none), then gated attention over
  the K cluster embeddings, with no mask.
- PatchGCN (`BatchedPatchGCN`, vlsa_tpu's vmap as one batched computation
  over [B, E] edge lists, under vlsa_tpu's `gcn` scope): GENConv layers
  (messages relu(x_src) + 1e-7, a per-destination softmax of t*m over the
  valid edges, a 2-layer MLP with LayerNorm), dense residual
  concatenation, the gated readout with the node mask.  The edges are kept
  as lists (`edge_lists`): the batch's valid edges, flattened over its
  graphs and sorted by destination once a batch (a stable sort), each node's
  incoming edges one segment, so memory grows with the edge count E, not
  with the largest in-degree.  Every per-destination sum is a segment
  reduction over them (`torch.segment_reduce`, each segment summed in a
  fixed order), and the backward of the gather by source sums each node's
  gradients over the same lists sorted by source (`_GatherRows`): no
  scatter-add, whose atomics on the card would make evaluation and
  training gradients differ run to run.  Out-of-range indices follow
  vlsa_tpu's JAX semantics: a source index past the bag is clamped to its
  last row (JAX clamps a gather), an edge whose destination lies outside
  the bag reaches no node (JAX drops it from a segment sum).  vlsa_tpu's
  graph bags make such edges for a patient of two or more slides
  (ROADMAP.md §C).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.masked import compute_float, masked_softmax
from .layers import GatedAttentionPooling, SeededDropout, TorchLinear
from .nystrom import NystromAttention


def _xavier(shape, generator) -> nn.Parameter:
    """flax's xavier_uniform: fan_in = shape[-2], fan_out = shape[-1] (times
    the leading dims)."""
    field = math.prod(shape[:-2]) if len(shape) > 2 else 1
    bound = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * field))
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


class TransLayer(nn.Module):
    """x + NystromAttention(LayerNorm(x)): 8 heads of dim/8, dim/2 landmarks."""

    def __init__(self, dim: int = 512, generator=None, seed: int = 0):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = NystromAttention(dim, dim_head=dim // 8, heads=8, num_landmarks=dim // 2,
                                     pinv_iterations=6, residual=True, dropout=0.1,
                                     generator=generator, seed=seed)

    def forward(self, x, mask=None, return_cls_attn=False, train=False):
        if return_cls_attn:
            out, attn = self.attn(self.norm(x), mask, return_cls_attn=True, train=train)
            return x + out, attn
        return x + self.attn(self.norm(x), mask, train=train)


class PPEG(nn.Module):
    """The cls token, then the H x W grid of tokens plus its depthwise 7x7,
    5x5 and 3x3 convolutions.  Kernels in torch's layout [C, 1, k, k]
    (vlsa_tpu's HWIO (k, k, 1, C))."""

    def __init__(self, dim: int = 512, generator=None):
        super().__init__()
        for name, k in (("proj", 7), ("proj1", 5), ("proj2", 3)):
            setattr(self, name, nn.Parameter(torch.empty(dim, 1, k, k).uniform_(
                -1.0 / k, 1.0 / k, generator=generator)))

    def forward(self, x, H: int, W: int):
        B, _n, C = x.shape
        cls_token, img = x[:, :1], x[:, 1:].transpose(1, 2).reshape(B, C, H, W)
        out = img + sum(F.conv2d(img, w, padding=w.shape[-1] // 2, groups=C)
                        for w in (self.proj, self.proj1, self.proj2))
        return torch.cat([cls_token, out.flatten(2).transpose(1, 2)], dim=1)


class TransMIL(nn.Module):
    accepts_x_scale = False
    uses_vl = False

    def __init__(self, dim_in: int = 512, dim_hid: int = 256, num_cls: int = 2,
                 generator: Optional[torch.Generator] = None, dropout_seed: int = 0):
        super().__init__()
        self.fc1 = TorchLinear(dim_in, dim_hid, generator=generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim_hid).normal_(generator=generator))
        self.layer1 = TransLayer(dim_hid, generator, dropout_seed)
        self.pos_layer = PPEG(dim_hid, generator)
        self.layer2 = TransLayer(dim_hid, generator, dropout_seed)
        self.norm = nn.LayerNorm(dim_hid, eps=1e-5)
        self.fc2 = TorchLinear(dim_hid, num_cls, generator=generator)

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None,
                ret_with_attn: bool = False, train: bool = False, **_):
        """X [B, N, D] -> logits [B, num_cls]; with `ret_with_attn`, (logits,
        the cls token's attention [B, N])."""
        B, N, _d = X.shape
        h = torch.relu(self.fc1(compute_float(X)))
        side = int(math.ceil(math.sqrt(N)))
        add = side * side - N
        if add > 0:
            h = torch.cat([h, h[:, :add]], dim=1)
            if mask is not None:
                mask = torch.cat([mask, mask[:, :add]], dim=1)
        h = torch.cat([self.cls_token.to(h.dtype).expand(B, -1, -1), h], dim=1)
        full_mask = None if mask is None else torch.cat(
            [torch.ones(B, 1, dtype=torch.bool, device=mask.device), mask], dim=1)
        h = self.layer1(h, full_mask, train=train)
        h = self.pos_layer(h, side, side)
        attn = None
        if ret_with_attn:
            h, row = self.layer2(h, full_mask, return_cls_attn=True, train=train)
            attn = row[:, :, 0, 1:1 + N].mean(dim=1)
        else:
            h = self.layer2(h, full_mask, train=train)
        logits = self.fc2(self.norm(h)[:, 0])
        return (logits, attn) if ret_with_attn else logits


class MultiHeadAttention(nn.Module):
    """vlsa_tpu's ILRA attention block (see the module's docstring)."""

    def __init__(self, dim_q: int, dim_k: int, dim_v: int, num_heads: int, ln: bool = False,
                 gated: bool = False, generator=None):
        super().__init__()
        d = dim_v
        self.num_heads, self.ln, self.gated = num_heads, ln, gated
        self.fc_q = TorchLinear(dim_q, d, generator=generator)
        self.fc_k = TorchLinear(dim_k, d, generator=generator)
        self.fc_v = TorchLinear(dim_k, d, generator=generator)
        self.in_proj = _xavier((3 * d, d), generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = TorchLinear(d, d, generator=generator)
        if ln:
            self.ln0 = nn.LayerNorm(d, eps=1e-5)
            self.ln1 = nn.LayerNorm(d, eps=1e-5)
        self.fc_o = TorchLinear(d, d, generator=generator)
        if gated:
            self.gate = TorchLinear(dim_q, d, generator=generator)

    def forward(self, Q_in, K_in, key_mask: Optional[torch.Tensor] = None):
        Q, K, V = self.fc_q(Q_in), self.fc_k(K_in), self.fc_v(K_in)
        B, Lq, d = Q.shape
        Lk, nh = K.shape[1], self.num_heads
        hd = d // nh
        w, b = self.in_proj, self.in_proj_bias
        q = Q @ w[:d].T + b[:d]
        k = K @ w[d:2 * d].T + b[d:2 * d]
        v = V @ w[2 * d:].T + b[2 * d:]
        q, k, v = (t.reshape(B, L, nh, hd).transpose(1, 2)
                   for t, L in ((q, Lq), (k, Lk), (v, Lk)))
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        km = None if key_mask is None else key_mask[:, None, None, :]
        out = torch.einsum("bhqk,bhkd->bhqd", masked_softmax(logits, km, dim=-1), v)
        O = Q + self.out_proj(out.transpose(1, 2).reshape(B, Lq, d))
        if self.ln:
            O = self.ln0(O)
        O = O + torch.relu(self.fc_o(O))
        if self.ln:
            O = self.ln1(O)
        if self.gated:
            O = O * F.silu(self.gate(Q_in))
        return O


class GAB(nn.Module):
    """Global attention bottleneck: `num_inds` latent queries attend the bag
    (masked), the bag attends them back."""

    def __init__(self, dim_in: int, dim_out: int, num_heads: int, num_inds: int,
                 ln: bool = False, generator=None):
        super().__init__()
        self.latent = _xavier((1, num_inds, dim_out), generator)
        self.project_forward = MultiHeadAttention(dim_out, dim_in, dim_out, num_heads, ln=ln,
                                                  gated=True, generator=generator)
        self.project_backward = MultiHeadAttention(dim_in, dim_out, dim_out, num_heads, ln=ln,
                                                   gated=True, generator=generator)

    def forward(self, X, mask=None):
        latent = self.latent.to(X.dtype).expand(X.shape[0], -1, -1)
        H = self.project_forward(latent, X, key_mask=mask)
        return self.project_backward(X, H)


class ILRA(nn.Module):
    accepts_x_scale = False
    uses_vl = False

    def __init__(self, dim_in: int = 512, dim_hid: int = 256, num_cls: int = 2,
                 num_layers: int = 2, num_heads: int = 8, topk: int = 1, ln: bool = False,
                 generator: Optional[torch.Generator] = None, dropout_seed: int = 0):
        super().__init__()
        del dropout_seed  # no dropout
        for idx in range(num_layers):
            setattr(self, f"gab_{idx}", GAB(dim_in if idx == 0 else dim_hid, dim_hid,
                                            num_heads, topk, ln=ln, generator=generator))
        self.num_layers = num_layers
        self.pool_seeds = _xavier((1, topk, dim_hid), generator)
        self.pooling = MultiHeadAttention(dim_hid, dim_hid, dim_hid, num_heads, ln=ln,
                                          generator=generator)
        self.classifier = TorchLinear(dim_hid, num_cls, generator=generator)

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, **_):
        X = compute_float(X)
        for idx in range(self.num_layers):
            X = getattr(self, f"gab_{idx}")(X, mask)
        seeds = self.pool_seeds.to(X.dtype).expand(X.shape[0], -1, -1)
        return self.classifier(self.pooling(seeds, X, key_mask=mask))[:, 0]


class DeepAttnMISL(nn.Module):
    accepts_x_scale = False
    uses_vl = False

    def __init__(self, dim_in: int = 512, dim_hid: int = 256, num_cls: int = 1,
                 num_clusters: int = 8, dropout: float = 0.25,
                 generator: Optional[torch.Generator] = None, dropout_seed: int = 0):
        super().__init__()
        self.num_clusters = num_clusters
        self.phis = TorchLinear(dim_in, dim_hid, generator=generator)
        self.attn_fc = TorchLinear(dim_hid, dim_hid, generator=generator)
        self.dropout = SeededDropout(dropout, dropout_seed)
        self.attention_net = GatedAttentionPooling(dim_hid, dim_hid, dropout=dropout,
                                                   seed=dropout_seed, generator=generator)
        self.output_layer = TorchLinear(dim_hid, num_cls, generator=generator)

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None,
                cluster_id: Optional[torch.Tensor] = None, train: bool = False, **_):
        """X [B, N, D], cluster_id [B, N] ints -> logits [B, num_cls]."""
        if cluster_id is None:
            raise ValueError("DeepAttnMISL requires cluster ids (data_mode: cluster)")
        h = torch.relu(self.phis(compute_float(X)))
        ks = torch.arange(self.num_clusters, device=h.device)
        onehot = (cluster_id[..., None].long() == ks).to(h.dtype)  # [B, N, K]
        if mask is not None:
            onehot = onehot * mask[..., None].to(h.dtype)
        counts = onehot.sum(dim=1)
        sums = torch.einsum("bnk,bnd->bkd", onehot, h)
        cluster_feat = sums / torch.clamp(counts[..., None], min=1.0)
        a_in = self.dropout(torch.relu(self.attn_fc(cluster_feat)), train)
        pooled, _ = self.attention_net(a_in, None, train=train)
        return self.output_layer(pooled)


def edge_lists(edge_index: torch.Tensor, edge_valid: Optional[torch.Tensor], N: int):
    """A batch's edges as lists over its B * N nodes (node i of graph b is
    b * N + i): (src [E] long, the sources of the edges sorted by
    destination; in_deg [B * N], each node's incoming edges, in that order;
    by_src [E], the order that sorts `src` (stable); out_deg [B * N]).  An
    edge counts when it is valid and its destination lies in [0, N); the
    edges of a node keep their order.  Sources follow JAX's gather: a
    negative index counts from the end, and the index is then clamped into
    [0, N)."""
    B = edge_index.shape[0]
    src, dst = edge_index[:, 0].long(), edge_index[:, 1].long()
    use = (dst >= 0) & (dst < N)
    if edge_valid is not None:
        use = use & edge_valid.bool()
    src = torch.where(src < 0, src + N, src).clamp(0, max(N - 1, 0))
    base = torch.arange(B, device=src.device)[:, None] * N
    src, dst = (src + base)[use], (dst + base)[use]
    src = src[torch.argsort(dst, stable=True)]
    return (src, torch.bincount(dst, minlength=B * N), torch.argsort(src, stable=True),
            torch.bincount(src, minlength=B * N))


class _GatherRows(torch.autograd.Function):
    """x[idx] for x [M, D]; its backward sums each row's gradients as a
    segment of the edges sorted by `idx` (`by_idx`, `counts` per row), in a
    fixed order (index_select's backward adds them with atomics on the
    card)."""

    @staticmethod
    def forward(ctx, x, idx, by_idx, counts):
        ctx.save_for_backward(by_idx, counts)
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        by_idx, counts = ctx.saved_tensors
        return (torch.segment_reduce(grad.index_select(0, by_idx), "sum", lengths=counts,
                                     axis=0), None, None, None)


def _aggregate(m, t, src, in_deg, by_src, out_deg):
    """For each node, the sum over its incoming edges of softmax(t * m_src) *
    m_src (each feature its own softmax): m [B, N, D] -> [B, N, D]."""
    B, N, D = m.shape
    msg = _GatherRows.apply(m.reshape(B * N, D), src, by_src, out_deg)  # [E, D]
    logits = t * msg
    top = torch.segment_reduce(logits.detach(), "max", lengths=in_deg, axis=0)
    top = torch.repeat_interleave(top, in_deg, dim=0, output_size=src.numel())
    ex = torch.exp(logits - top)
    denom = torch.segment_reduce(ex, "sum", lengths=in_deg, axis=0)
    numer = torch.segment_reduce(ex * msg, "sum", lengths=in_deg, axis=0)
    return (numer / denom.clamp(min=1e-16)).reshape(B, N, D)


class GENConvLayer(nn.Module):
    """h = x + sum over incoming edges of softmax(t * m) * m, m = relu(x_src)
    + eps (each feature its own softmax over the node's edges), then
    mlp2(relu(LayerNorm(mlp1(h)))).  Under autograd the aggregation's [E, D]
    tensors are formed again in the backward instead of kept (activation
    checkpointing: the same values, less memory)."""

    def __init__(self, dim: int, eps: float = 1e-7, generator=None):
        super().__init__()
        self.eps = eps
        self.t = nn.Parameter(torch.ones(()))
        self.mlp1 = TorchLinear(dim, 2 * dim, generator=generator)
        self.mlp_norm = nn.LayerNorm(2 * dim, eps=1e-5)
        self.mlp2 = TorchLinear(2 * dim, dim, generator=generator)

    def forward(self, x: torch.Tensor, edges: tuple):
        m = torch.relu(x) + self.eps
        if torch.is_grad_enabled() and (m.requires_grad or self.t.requires_grad):
            aggr = checkpoint(_aggregate, m, self.t, *edges, use_reentrant=False)
        else:
            aggr = _aggregate(m, self.t, *edges)
        return self.mlp2(torch.relu(self.mlp_norm(self.mlp1(x + aggr))))


class PatchGCN(nn.Module):
    """The batched graph network under BatchedPatchGCN's `gcn` scope."""

    def __init__(self, dim_in: int = 512, dim_hid: int = 128, num_cls: int = 4,
                 num_layers: int = 3, dropout: float = 0.25, generator=None,
                 dropout_seed: int = 0):
        super().__init__()
        self.num_layers = num_layers
        self.fc = TorchLinear(dim_in, dim_hid, generator=generator)
        self.conv0 = GENConvLayer(dim_hid, generator=generator)
        for i in range(1, num_layers):
            setattr(self, f"norm{i}", nn.LayerNorm(dim_hid, eps=1e-5))
            setattr(self, f"conv{i}", GENConvLayer(dim_hid, generator=generator))
        self.path_phi = TorchLinear(dim_hid * (num_layers + 1), dim_hid, generator=generator)
        self.path_attention_head = GatedAttentionPooling(dim_hid, dim_hid, dropout=dropout,
                                                         seed=dropout_seed, generator=generator)
        self.output_layer = TorchLinear(dim_hid, num_cls, generator=generator)
        self.dropout = SeededDropout(dropout, dropout_seed)
        self.dropout_mid = SeededDropout(0.1, dropout_seed)

    def forward(self, X, edge_index, mask=None, edge_valid=None, train=False):
        edges = edge_lists(edge_index, edge_valid, X.shape[1])
        x = self.dropout(torch.relu(self.fc(compute_float(X))), train)
        h = self.conv0(x, edges)
        x_cat = [x, h]
        for i in range(1, self.num_layers):
            hn = self.dropout_mid(torch.relu(getattr(self, f"norm{i}")(h)), train)
            h = h + getattr(self, f"conv{i}")(hn, edges)
            x_cat.append(h)
        h_path = self.dropout(torch.relu(self.path_phi(torch.cat(x_cat, dim=-1))), train)
        pooled, _ = self.path_attention_head(h_path, mask, train=train)
        return self.output_layer(pooled)


class BatchedPatchGCN(nn.Module):
    """X [B, N, D], mask [B, N], edge_index [B, 2, E], edge_valid [B, E] ->
    logits [B, num_cls]."""
    accepts_x_scale = False
    uses_vl = False

    def __init__(self, generator: Optional[torch.Generator] = None, dropout_seed: int = 0,
                 **kws):
        super().__init__()
        self.gcn = PatchGCN(generator=generator, dropout_seed=dropout_seed, **kws)

    def forward(self, X: torch.Tensor, mask: Optional[torch.Tensor] = None,
                edge_index: Optional[torch.Tensor] = None,
                edge_valid: Optional[torch.Tensor] = None, train: bool = False, **_):
        if edge_index is None:
            raise ValueError("PatchGCN requires edge_index (data_mode: graph)")
        return self.gcn(X, edge_index, mask=mask, edge_valid=edge_valid, train=train)
