"""Recsys / PS operator tier — the port's copy of `paddle_tpu/ops/recsys.py`.

Reference parity (semantics, not implementation):
  tdm_child            paddle/fluid/operators/tdm_child_op.h:36
  tdm_sampler          .../tdm_sampler_op.h:39 (layer-wise NCE sampling)
  cvm                  .../cvm_op.h:26 (show/click prefix, custom grad)
  data_norm            .../data_norm_op.cc:287 (summary stats normalize)
  batch_fc             .../batch_fc_op.cu (per-slot batched GEMM + bias)
  rank_attention       .../rank_attention.cu.h:28 (rank-block expand + GEMM)
  shuffle_batch        .../shuffle_batch_op.cc:82
  match_matrix_tensor  .../match_matrix_tensor_op.cc:218 (X·W_t·Yᵀ)
  var_conv_2d          .../var_conv_2d_op.cc (variable-size conv)
  tree_conv            .../tree_conv_op.cc + math/tree2col.cc (TBCNN)
  pyramid_hash         .../pyramid_hash_op.cc:226 (hashed n-gram embedding)
  filter_by_instag     .../filter_by_instag_op.cc

The FLOP-carrying parts are dense gathers and batched products that run
on the inputs' device (batch_fc, rank_attention, match_matrix, tree_conv's
patch = Eta @ features form, pyramid_hash's gather). The data-dependent
preparation (tdm_sampler's rejection sampling, tree2col's DFS, n-gram
hashing, filter_by_instag's row choice) runs on the host in numpy, the
reference's own split (those kernels are CPU-only there), with results
equal to the JAX package's. LoD inputs are padded dense batches plus
lengths.

Functions take tensors or arrays and return torch tensors; gradients
flow through torch autograd (CVM's two custom gradients are autograd
Functions).
"""
import hashlib

import numpy as np
import torch
from torch.nn import functional as _tF


def _t(x, device=None):
    """x as a tensor (arrays keep their dtype), on `device` when given."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    return t if device is None else t.to(device)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# TDM (tree-based deep match)
# ---------------------------------------------------------------------------

def tdm_child(x, tree_info, child_nums):
    """Children + leaf mask of each node id (tdm_child_op.h:36).

    tree_info rows: [item_id, layer_id, ancestor_id, child_0..child_n-1];
    node 0 or a zero child_0 means "no children". A child is a leaf when
    its item_id (col 0) is nonzero. Returns (children, leaf), int32.
    """
    ids = _t(x).to(torch.int64)
    info = _t(tree_info, ids.device).to(torch.int32)
    rows = info[ids]                                   # [..., length]
    has_child = (ids != 0) & (rows[..., 3] != 0)
    zero = torch.zeros((), dtype=torch.int32, device=ids.device)
    children = torch.where(has_child[..., None],
                           rows[..., 3:3 + child_nums], zero)
    leaf = (children > 0) & (info[children.to(torch.int64)][..., 0] != 0)
    leaf = leaf & has_child[..., None]
    return children, leaf.to(torch.int32)


def tdm_sampler(x, travel, layer, neg_samples_num_list, layer_offset_lod,
                output_positive=True, seed=0):
    """Layer-wise NCE sampling along each item's tree path
    (tdm_sampler_op.h:39), on the host like the reference's CPU-only
    kernel: rejection sampling from `np.random.RandomState(seed)` (the
    JAX package's draws, bit for bit) avoids the positive and
    duplicates; a zero travel entry is path padding -> masked row.

    x: [N] item ids; travel: [num_items, layer_nums] path node ids;
    layer: flat per-layer node-id array with layer_offset_lod offsets.
    Returns (out, labels, mask), each [N, sum(neg+pos)] int32 host
    tensors.
    """
    ids = _np(x).reshape(-1)
    travel = _np(travel)
    layer_flat = _np(layer).reshape(-1)
    offs = list(layer_offset_lod)
    layer_nums = len(neg_samples_num_list)
    pos = 1 if output_positive else 0
    width = sum(n + pos for n in neg_samples_num_list)
    rng = np.random.RandomState(seed)

    out = np.zeros((len(ids), width), np.int32)
    lab = np.zeros((len(ids), width), np.int32)
    msk = np.ones((len(ids), width), np.int32)
    for i, item in enumerate(ids):
        col = 0
        path = travel[int(item)]
        for li in range(layer_nums):
            n_neg = neg_samples_num_list[li]
            nodes = layer_flat[offs[li]:offs[li + 1]]
            positive = int(path[li])
            if positive == 0:                      # path padding
                out[i, col:col + n_neg + pos] = 0
                lab[i, col:col + n_neg + pos] = 0
                msk[i, col:col + n_neg + pos] = 0
                col += n_neg + pos
                continue
            if pos:
                out[i, col] = positive
                lab[i, col] = 1
                col += 1
            avail = int((nodes != positive).sum())
            if n_neg > avail:
                raise ValueError(
                    f"tdm_sampler: layer {li} has only {avail} distinct "
                    f"non-positive nodes but neg_samples_num_list[{li}]="
                    f"{n_neg} (reference validates sample_num <= "
                    "node_nums - 1)")
            chosen = set()
            for _ in range(n_neg):
                while True:
                    j = rng.randint(0, len(nodes))
                    if nodes[j] != positive and j not in chosen:
                        chosen.add(j)
                        break
                out[i, col] = nodes[j]
                lab[i, col] = 0
                col += 1
    return torch.from_numpy(out), torch.from_numpy(lab), \
        torch.from_numpy(msk)


# ---------------------------------------------------------------------------
# CTR feature ops
# ---------------------------------------------------------------------------

class _CvmUse(torch.autograd.Function):
    """use_cvm: log(show + 1), log(click + 1) - log(show + 1), the rest
    as is. Reference grad (cvm_op.h:42): the show/click columns take
    their cotangent from the CVM input, the rest passes through; none
    reaches the CVM input."""

    @staticmethod
    def forward(ctx, x, cvm):
        ctx.save_for_backward(cvm)
        y0 = torch.log(x[:, :1] + 1)
        y1 = torch.log(x[:, 1:2] + 1) - y0
        return torch.cat([y0, y1, x[:, 2:]], dim=1)

    @staticmethod
    def backward(ctx, dy):
        (cvm,) = ctx.saved_tensors
        lead = cvm[:, :2].expand(dy.shape[0], 2).to(dy.dtype)
        return torch.cat([lead, dy[:, 2:]], dim=1), torch.zeros_like(cvm)


class _CvmDrop(torch.autograd.Function):
    """Without use_cvm: the show/click columns are dropped; their dx
    comes from the CVM input as above."""

    @staticmethod
    def forward(ctx, x, cvm):
        ctx.save_for_backward(cvm)
        return x[:, 2:].clone()

    @staticmethod
    def backward(ctx, dy):
        (cvm,) = ctx.saved_tensors
        lead = cvm[:, :2].expand(dy.shape[0], 2).to(dy.dtype)
        return torch.cat([lead, dy], dim=1), torch.zeros_like(cvm)


def continuous_value_model(input, cvm, use_cvm=True):
    """cvm op (cvm_op.h:26): the first two columns are show/click. With
    use_cvm they become log(show+1), log(click+1)-log(show+1) and the
    width is kept; without, they are dropped. Gradient parity: the two
    lead columns' dx comes from the CVM input."""
    x = _t(input)
    fn = _CvmUse if use_cvm else _CvmDrop
    return fn.apply(x, _t(cvm, x.device))


def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4):
    """data_norm_op.cc:287 — normalize by summary statistics:
    means = batch_sum / batch_size, scales = sqrt(batch_size /
    batch_square_sum); y = (x - means) * scales. Returns (y, means,
    scales)."""
    xa = _t(x)
    bsize = _t(batch_size, xa.device).to(torch.float32)
    means = _t(batch_sum, xa.device).to(torch.float32) / bsize
    scales = torch.sqrt(bsize / _t(batch_square_sum, xa.device).to(
        torch.float32))
    return (xa - means) * scales, means, scales


def data_norm_update(x, batch_size, batch_sum, batch_square_sum,
                     summary_decay=0.9999999):
    """The summary-update half of data_norm: decay the running stats and
    add this batch's size/sum/square-sum (data_norm_op.cc grad kernel's
    stat accumulation)."""
    xa = _t(x).to(torch.float32)
    n = xa.shape[0]
    dev = xa.device
    new_size = _t(batch_size, dev) * summary_decay + n
    new_sum = _t(batch_sum, dev) * summary_decay + xa.sum(0)
    new_sq = _t(batch_square_sum, dev) * summary_decay + (xa * xa).sum(0)
    return new_size, new_sum, new_sq


def batch_fc(input, w, bias=None):
    """batch_fc_op: per-slot FC. input [S, N, D] · w [S, D, O] + b [S, O]
    → [S, N, O] — one batched GEMM."""
    x = _t(input)
    out = torch.bmm(x, _t(w, x.device))
    if bias is not None:
        out = out + _t(bias, x.device)[:, None, :]
    return out


def rank_attention(input, rank_offset, rank_param, max_rank):
    """rank_attention_op (rank_attention.cu.h:28): each instance carries
    up to max_rank (faster-rank, peer-index) slots in rank_offset
    [N, 1+2k]; the input rows indexed by the slots form a [k*D] block
    row, the (lower_rank, faster_rank) blocks of rank_param
    [k*k*D, P] form a [k*D, P] block matrix, and out[i] = block_row @
    block_matrix. Invalid slots (rank <= 0) contribute zeros."""
    x = _t(input)
    param = _t(rank_param, x.device)
    ro = _t(rank_offset, x.device).to(torch.int64)
    n, d = x.shape
    p = param.shape[1]
    k = max_rank

    lower = ro[:, 0] - 1                              # [N]
    faster = ro[:, 1::2] - 1                          # [N, k]
    index = ro[:, 2::2]                               # [N, k]
    valid = (lower[:, None] >= 0) & (faster >= 0)     # [N, k]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    # input_help [N, k, D]: row X[index_k] per valid slot
    ih = torch.where(valid[..., None], x[index.clamp(0, n - 1)], zero)
    # param blocks [N, k, D, P]: block (lower*k + faster) of rank_param
    start = (lower[:, None] * k + faster).clamp(0, k * k - 1)
    blocks = param.reshape(k * k, d, p)[start]        # [N, k, D, P]
    blocks = torch.where(valid[..., None, None], blocks, zero)
    return torch.einsum('nkd,nkdp->np', ih, blocks)


def _shuffle_take(x, perm):
    """x's rows (all dims but the last flattened as the row axis) taken
    in the order `perm`: the gather of shuffle_batch, whose gradient
    scatters back (unshuffles)."""
    lead = int(np.prod(x.shape[:-1])) if x.dim() > 1 else x.shape[0]
    flat = x.reshape(lead, -1) if x.dim() > 1 else x
    perm = _t(perm, x.device).to(torch.int64)
    return flat.index_select(0, perm).reshape(x.shape)


def shuffle_batch(x, seed=0):
    """shuffle_batch_op.cc:82 — shuffle rows (all dims but the last are
    flattened as the row axis). Returns (out, shuffle_idx int32);
    gradients unshuffle through the gather. The permutation is drawn
    from a host torch.Generator seeded with `seed`: a torch stream, not
    the JAX package's threefry one, which torch cannot reproduce."""
    xa = _t(x)
    lead = int(np.prod(xa.shape[:-1])) if xa.dim() > 1 else xa.shape[0]
    perm = torch.randperm(lead, generator=torch.Generator().manual_seed(
        int(seed)))
    return _shuffle_take(xa, perm), perm.to(torch.int32)


def match_matrix_tensor(x, y, w, x_len=None, y_len=None):
    """match_matrix_tensor_op.cc:218 — out[b,t] = X_b · W_t · Y_bᵀ.
    Dense form: x [B, Lx, D], y [B, Ly, D], w [D, T, D] → [B, T, Lx, Ly];
    positions past x_len/y_len are masked to 0 (the LoD replacement)."""
    xa = _t(x)
    ya = _t(y, xa.device)
    out = torch.einsum('bxd,dte,bye->btxy', xa, _t(w, xa.device), ya)
    if x_len is not None:
        mx = torch.arange(xa.shape[1], device=xa.device)[None, :] < _t(
            x_len, xa.device)[:, None]
        out = out * mx[:, None, :, None]
    if y_len is not None:
        my = torch.arange(ya.shape[1], device=xa.device)[None, :] < _t(
            y_len, xa.device)[:, None]
        out = out * my[:, None, None, :]
    return out


def _same_pad(size, k, stride):
    """XLA's SAME padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def var_conv_2d(x, w, input_channel, output_channel, filter_size, stride=1,
                row_lens=None, col_lens=None):
    """var_conv_2d_op — conv over per-sample-sized images. Dense form:
    x [B, C, H, W] padded; rows/cols past each sample's (row_lens[i],
    col_lens[i]) are zeroed before AND after the conv, so the valid
    region matches a per-sample conv on the true size. SAME padding as
    XLA places it (the extra row or column after)."""
    xa = _t(x)
    wa = _t(w, xa.device).reshape(output_channel, input_channel,
                                  filter_size, filter_size)

    def mask(t, rl, cl):
        m = ((torch.arange(t.shape[2], device=t.device)[None, :, None]
              < rl[:, None, None]) &
             (torch.arange(t.shape[3], device=t.device)[None, None, :]
              < cl[:, None, None]))
        return t * m[:, None, :, :].to(t.dtype)

    masked = row_lens is not None
    if masked:
        rl, cl = _t(row_lens, xa.device), _t(col_lens, xa.device)
        xa = mask(xa, rl, cl)
    ph = _same_pad(xa.shape[2], filter_size, stride)
    pw = _same_pad(xa.shape[3], filter_size, stride)
    out = _tF.conv2d(_tF.pad(xa, (pw[0], pw[1], ph[0], ph[1])), wa,
                     stride=stride)
    if masked:
        out = mask(out, ((rl + stride - 1) // stride).clamp(min=1),
                   ((cl + stride - 1) // stride).clamp(min=1))
    return out


# ---------------------------------------------------------------------------
# tree_conv (TBCNN)
# ---------------------------------------------------------------------------

def _tree2col_eta(edges, num_nodes, max_depth):
    """Host-side tree2col (math/tree2col.cc:23): for every node u, DFS
    its patch to max_depth; each patch member v contributes with weights
    (eta_l, eta_r, eta_t). Returned as THREE dense [P, num_nodes]
    matrices so the patch becomes Eta_s @ features — a dense matmul
    instead of the reference's scatter loop."""
    tr = [[] for _ in range(num_nodes + 1)]
    for u, v in edges:
        if u != 0 and v != 0:
            tr[int(u)].append(int(v))
        else:
            break

    etas = []          # per patch: list of (node, index, pclen, depth)
    for root in range(1, num_nodes + 1):
        stack = [(root, 1, 1, 0)]
        patch = [(root, 1, 1, 0)]
        visited = {root}
        while stack:
            node, idx, pclen, depth = stack[-1]
            end = True
            for i, v in enumerate(tr[node]):
                if v not in visited and depth + 1 < max_depth:
                    visited.add(v)
                    stack.append((v, i, len(tr[node]), depth + 1))
                    patch.append((v, i + 1, len(tr[node]), depth + 1))
                    end = False
            if end:
                stack.pop()
        etas.append(patch)

    P = len(etas)
    E = np.zeros((3, P, num_nodes), np.float32)     # l, r, t
    fd = float(max_depth)
    for pi, patch in enumerate(etas):
        for node, idx, pclen, depth in patch:
            eta_t = (fd - depth) / fd
            tmp = 0.5 if pclen == 1 else (idx - 1.0) / (pclen - 1.0)
            eta_l = (1.0 - eta_t) * tmp
            eta_r = (1.0 - eta_t) * (1.0 - tmp)
            E[0, pi, node - 1] += eta_l
            E[1, pi, node - 1] += eta_r
            E[2, pi, node - 1] += eta_t
    return E


def tree_conv(nodes_vector, edge_set, filter, max_depth=2):
    """tree_conv_op (TBCNN, arxiv 1409.5718): per sample, build the
    continuous-binary-tree patch matrices on the host, then
    out[p, o, m] = Σ_{f,s} (Eta_s @ X)[p, f] · filter[f, s, o, m] on the
    features' device.

    nodes_vector [B, N, F]; edge_set [B, E, 2] int (0,0-padded);
    filter [F, 3, O, M] → out [B, P, O, M] (P = N patches, zero rows for
    nodes past each sample's count)."""
    xs = _t(nodes_vector)
    w = _t(filter, xs.device)
    edges = _np(edge_set)
    B, N, F = xs.shape
    etas = []
    for b in range(B):
        nc = 0
        for u, v in edges[b]:
            if u != 0 and v != 0:
                nc += 1
            else:
                break
        num_nodes = nc + 1          # reference construct_tree: +1 always
        Eb = np.zeros((3, N, N), np.float32)
        E = _tree2col_eta(edges[b], num_nodes, max_depth)
        Eb[:, :E.shape[1], :E.shape[2]] = E
        etas.append(Eb)
    eta = torch.from_numpy(np.stack(etas)).to(xs.device)     # [B, 3, N, N]
    patch = torch.einsum('bspn,bnf->bpfs', eta, xs)          # [B, P, F, 3]
    return torch.einsum('bpfs,fsom->bpom', patch, w)


# ---------------------------------------------------------------------------
# pyramid_hash
# ---------------------------------------------------------------------------

def _hash32(data, seed):
    h = hashlib.blake2s(data, digest_size=4,
                        salt=seed.to_bytes(8, 'little'))
    return int.from_bytes(h.digest(), 'little')


def pyramid_hash(x, w, num_emb, space_len, pyramid_layer=2, rand_len=16,
                 seq_lens=None, seed=0):
    """pyramid_hash_op.cc:226 — every n-gram (n = 2..pyramid_layer) of
    each sequence hashes to num_emb/rand_len slices of the hash-space
    weight table w [space_len + rand_len, 1]; a gram's embedding is the
    concatenation of those slices. Dense pooled form: x [B, L] int
    tokens (seq_lens masks padding) → [B, num_emb] sum over the
    sequence's grams. Hash identity: blake2s with the JAX package's salt
    and byte layout (bit for bit), standing in for XXH32. Differentiable
    w.r.t. w (the gather runs on w's device; hashing is host-side int
    prep)."""
    ids = _np(x)
    wa = _t(w)
    B, L = ids.shape
    lens = _np(seq_lens).reshape(-1) if seq_lens is not None \
        else np.full(B, L, np.int64)
    n_slice = num_emb // rand_len
    max_grams = max(1, sum(max(0, L - n + 1)
                    for n in range(2, pyramid_layer + 1)))
    gather = np.zeros((B, max_grams, n_slice), np.int64)
    gmask = np.zeros((B, max_grams), np.float32)
    for b in range(B):
        g = 0
        for nlen in range(2, pyramid_layer + 1):
            for s in range(int(lens[b]) - nlen + 1):
                gram = np.ascontiguousarray(
                    ids[b, s:s + nlen].astype(np.int32)).tobytes()
                for j in range(n_slice):
                    gather[b, g, j] = _hash32(gram, seed + j) % space_len
                gmask[b, g] = 1.0
                g += 1
    idx = torch.from_numpy(gather).to(wa.device)[..., None] \
        + torch.arange(rand_len, device=wa.device)[None, None, None, :]
    gm = torch.from_numpy(gmask).to(wa.device)
    rows = wa.reshape(-1)[:space_len + rand_len][idx]     # [B, G, S, rand]
    emb = rows.reshape(B, max_grams, num_emb)
    return (emb * gm[..., None]).sum(1)


# ---------------------------------------------------------------------------
# filter_by_instag
# ---------------------------------------------------------------------------

def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True,
                     out_val_if_empty=0):
    """filter_by_instag_op.cc — keep only the instances whose tag set
    intersects `filter_tag` (ad-targeting row filter). Dense contract:
    ins [N, D]; ins_tag [N, T] padded with -1 (the LoD multi-tag rows);
    filter_tag [F].

    Host-side data-prep op (data-dependent output length). Returns host
    tensors: (filtered rows [M, D] — or a single out_val_if_empty row
    when no instance matches, like the reference — loss_weight [M, 1],
    index map [M])."""
    x = _np(ins)
    tags = _np(ins_tag)
    if tags.ndim == 1:
        tags = tags[:, None]
    fset = set(int(t) for t in _np(filter_tag).reshape(-1))
    keep = [i for i in range(x.shape[0])
            if fset & set(int(t) for t in tags[i] if t >= 0)]
    if keep:
        rows = x[np.asarray(keep)]
        lw = np.ones((len(keep), 1), np.float32)
        idx = np.asarray(keep, np.int64)
    else:
        rows = np.full((1,) + x.shape[1:], out_val_if_empty, x.dtype)
        lw = np.zeros((1, 1), np.float32)
        idx = np.zeros((1,), np.int64)
    return (torch.from_numpy(np.ascontiguousarray(rows)),
            torch.from_numpy(lw), torch.from_numpy(idx))
