"""Wire-layout entry points around the kernels, and the server flush.

Counterpart of ``repro/kernels/ops.py``. A message of n elements lives on
the wire as ``rows_for(n) = ceil(n / 128)`` packed code rows plus one f32
bucket norm per row; the tail of the last row is zero-padded here (zero
elements encode to zero codes) and sliced off after decoding. The
reference's second, kernel-tile layout (rows padded to 256) has no
counterpart: the CUDA kernels take wire rows as they come.

``cohort_train_encode_step`` is the client side of one cohort tier group
(or of one client, b = 1): a per-member update from the flat x-hat,
vmapped over the members, and one encode launch over the (b, d) delta
stack — for a lowrank quantizer over the sketch of the error-compensated
stack, with the decode and expand that give each member's new residual.
``server_flush_step`` is the whole QAFeL buffer flush (Algorithm 1 lines
11-16) as a short chain of launches: the fused dequantize-accumulate (or,
for a lowrank window, ``lowrank_window_delta``), the FedBuff momentum and
server update, the broadcast quantize-pack and the hidden-state apply of
the decoded broadcast bits.

With ``taps=True`` both add their metric taps (``kernels.taps``): one more
launch each, reading what the step already computed; the other outputs
are the same tensors as with taps off.
"""
from __future__ import annotations

import torch

from repro_torch.common.device import to_device
from repro_torch.common.tree import tree_map
from repro_torch.kernels import buffer_agg as _agg
from repro_torch.kernels import qsgd as _qsgd
from repro_torch.kernels import taps as _taps
from repro_torch.kernels.ref import LANES, fma_f32
from repro_torch.kernels.ref import rows2d, rows_for  # noqa: F401 (re-export)


def qsgd_quantize(flat: torch.Tensor, key, bits: int = 4):
    """Quantize one flat f32 message with the threefry dither
    ``uniform(key, (rows, 128))`` (the reference's b=1 wire convention).
    On the card this is one launch: the kernel pads the ragged last row
    and draws the dither itself. Returns (packed uint8 (rows, 16*bits),
    norms f32 (rows,))."""
    return _qsgd.qsgd_quantize_pack_threefry(
        flat.to(torch.float32).contiguous(), key, bits)


def qsgd_quantize_chunk(flat_chunk: torch.Tensor, key, row_start: int, *,
                        bits: int, total_rows: int, threefry: bool = True):
    """Encode rows ``[row_start, row_start + rows_c)`` of a flat message of
    ``total_rows`` wire rows, ``rows_c = ceil(len(flat_chunk) / 128)`` (a
    ragged chunk is zero-padded to whole rows by the kernel): the
    streaming encode, one launch per chunk, whose chunks reassemble to the
    whole message's codes bit for bit at any chunking.

    ``threefry=True`` is the b=1 upload's convention (``qsgd_quantize``):
    the dither of the chunk's element i is that of element
    ``row_start*128 + i`` of ``uniform(key, (total_rows, 128))``, drawn in
    K1 from the global row offset. ``threefry=False`` is the batched
    counter hash keyed by the first two words of ``key`` and the global
    element index (K2 with a row offset). Returns ``(packed uint8
    (rows_c, 16*bits), norms f32 (rows_c,))``."""
    flat_chunk = flat_chunk.to(torch.float32).contiguous()
    rows_c = rows_for(flat_chunk.numel())
    if row_start < 0 or row_start + rows_c > total_rows:
        raise ValueError(f"rows [{row_start}, {row_start + rows_c}) lie "
                         f"outside a message of {total_rows} rows")
    if threefry:
        return _qsgd.qsgd_quantize_pack_threefry(
            flat_chunk, key, bits, row0=row_start, total_rows=total_rows)
    seeds = torch.as_tensor(key).reshape(1, -1)[:, :2]
    packed, norms = _qsgd.qsgd_quantize_pack_batch_flat(
        flat_chunk[None], seeds, bits, row0=row_start)
    return packed[0], norms[0]


def qsgd_encode_chunks(rows_fn, n: int, keys, bits: int, chunk_rows: int,
                       *, threefry: bool = True, row0: int = 0,
                       total_rows=None):
    """The streaming encode's one loop: a message block of n elements
    whose first wire row is row ``row0`` of its message (of
    ``total_rows`` rows; default ``row0 + rows_for(n)``), encoded
    ``chunk_rows`` wire rows at a time, each chunk keyed by its global row
    offset, so the chunks are the unchunked encode's rows bit for bit. The
    f32 values are formed on request: ``rows_fn(a, e)`` returns elements
    ``[a, e)`` of the block as a (B, e - a) stack. ``threefry=True``
    (B == 1, ``keys`` one key) is K1's dither (``qsgd_quantize_chunk``);
    ``threefry=False`` the counter hash keyed by the (B, 2) ``keys``, one
    K2 launch per chunk. Yields ``(r0, r1, packed, norms)`` for the
    block's rows ``[r0, r1)``: (r1 - r0, 16*bits) and (r1 - r0,) at
    threefry, else with the leading B."""
    rows = rows_for(n)
    total_rows = row0 + rows if total_rows is None else int(total_rows)
    c = int(chunk_rows)
    if c <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    for r0 in range(0, rows, c):
        r1 = min(rows, r0 + c)
        x = rows_fn(r0 * LANES, min(n, r1 * LANES))
        if threefry:
            p, nm = qsgd_quantize_chunk(x.reshape(-1), keys, row0 + r0,
                                        bits=bits, total_rows=total_rows)
        else:
            p, nm = _qsgd.qsgd_quantize_pack_batch_flat(
                x.to(torch.float32).contiguous(), keys, bits, row0=row0 + r0)
        yield r0, r1, p, nm


def qsgd_quantize_rows(rows_fn, n: int, keys, bits: int, chunk_rows: int, *,
                       device, b: int = 1, threefry: bool = True,
                       row0: int = 0, total_rows=None):
    """The whole (B, rows) message stack of ``qsgd_encode_chunks`` (same
    arguments; ``b`` the stack's B): only the codes and the norms exist
    whole. Returns ``(packed (b, rows, 16*bits), norms (b, rows))``, bit
    for bit the unchunked encode's."""
    rows = rows_for(n)
    packed = torch.empty((b, rows, LANES * bits // 8), dtype=torch.uint8,
                         device=device)
    norms = torch.empty((b, rows), dtype=torch.float32, device=device)
    for r0, r1, p, nm in qsgd_encode_chunks(rows_fn, n, keys, bits,
                                            chunk_rows, threefry=threefry,
                                            row0=row0,
                                            total_rows=total_rows):
        packed[:, r0:r1], norms[:, r0:r1] = p, nm
    return packed, norms


def qsgd_quantize_batch(flat_batch: torch.Tensor, keys, bits: int = 4):
    """Quantize a (B, n) stack in one launch (the kernel pads the ragged
    last rows); message b's dither is the counter hash keyed by the two
    words of ``keys[b]``. Returns (packed uint8 (B, rows, 16*bits), norms
    f32 (B, rows))."""
    return _qsgd.qsgd_quantize_pack_batch_flat(
        flat_batch.to(torch.float32).contiguous(), keys, bits)


def qsgd_dequantize(packed: torch.Tensor, norms: torch.Tensor, bits: int,
                    n: int) -> torch.Tensor:
    """Dequantize wire-layout codes back to a flat f32 vector of length n."""
    return _qsgd.qsgd_unpack_dequantize(packed, norms, bits).reshape(-1)[:n]


def buffer_aggregate(packed_stack: torch.Tensor, norms: torch.Tensor,
                     weights: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Fused weighted dequantized sum of the K buffered messages -> (n,)."""
    out2d = _agg.buffer_aggregate(packed_stack, norms, weights, bits)
    return out2d.reshape(-1)[:n]


def qsgd_dequantize_stack(packed: torch.Tensor, norms: torch.Tensor,
                          bits: int, n: int, *,
                          eager: bool = False) -> torch.Tensor:
    """Dequantize a (B, rows, 16*bits) stack of wire messages of n
    elements in one K3 launch -> f32 (B, n); ``eager`` as in
    ``qsgd.qsgd_unpack_dequantize``."""
    b, rows = packed.shape[0], packed.shape[1]
    out = _qsgd.qsgd_unpack_dequantize(packed.reshape(b * rows, -1),
                                       norms.reshape(b * rows), bits,
                                       eager=eager)
    return out.reshape(b, rows * _qsgd.LANES)[:, :n]


def lowrank_window_delta(stack, norms, weights, seeds, *, bits: int,
                         group: int, n: int, eager: bool = False,
                         elem0: int = 0,
                         n_out=None) -> torch.Tensor:
    """The weighted expansion of one lowrank flush window -> f32 (n,):
    ``sum_k w_k * S_k^T y_k`` over the padded length, sliced to n.

    ``stack`` / ``norms`` are the K rank-length wire pairs, ``seeds`` the
    (K, 2) per-upload basis seed pairs (a window spans model versions),
    ``weights`` the normalized staleness weights. One K3 launch decodes
    the K subspace vectors; each is expanded under its own seeds and the
    sum runs ``acc = acc + p_k`` over ascending k, product and sum
    rounded apart (the reference pins each product behind a hard
    boundary; this is not K4's FMA chain). It starts at ``p_0`` itself,
    not at ``+0 + p_0`` (XLA folds the add of zero), so a -0 product keeps
    its sign. The product is the reference's
    ``w_k * ((repeat(y_k) * sign_k) * fl32(1/sqrt(group)))`` as XLA:CPU
    reassociates it in the jitted flush: ``(w_k * fl32(1/sqrt(group))) *
    (repeat(y_k) * sign_k)``.

    ``eager=True`` is the reference's non-fused chain (``FlushBatch
    .reduce`` under a sparse or lowrank server quantizer), which runs this
    op by op: K3's eager variant decodes with a true division by s, each
    product rounds as written, ``w_k * ((repeat(y_k) * sign_k) *
    fl32(1/sqrt(group)))``, and the sum starts from +0.

    ``n_out`` gives the elements ``[elem0, elem0 + n_out)`` of the same
    expansion (a group-aligned segment of a mesh's padded flat vector),
    each the unsplit expansion's bits, zero at ``n`` and past it: the
    subspace coordinates past the decoded rank read as zero."""
    d_pad = rows_for(n) * _qsgd.LANES
    k = stack.shape[0]
    if eager:
        y = qsgd_dequantize_stack(stack, norms, bits, d_pad // group,
                                  eager=True)
        acc = torch.zeros(d_pad, dtype=torch.float32, device=y.device)
        for i in range(k):
            acc = acc + weights[i] * _qsgd.sketch_expand(
                y[i:i + 1], seeds[i], group)[0]
        return acc[:n]
    width = d_pad if n_out is None else n_out
    lo, hi = elem0 // group, (elem0 + width) // group
    y = qsgd_dequantize_stack(stack, norms, bits,
                              stack.shape[1] * _qsgd.LANES)
    y = torch.nn.functional.pad(y, (0, max(0, hi - y.shape[1])))
    ws = weights * _qsgd.sketch_scale(group)
    prods = ws[:, None] * _qsgd.sketch_expand(
        y[:, lo:hi], seeds, group, offset=elem0, scaled=False)
    acc = prods[0]
    for i in range(1, k):
        acc = acc + prods[i]
    if n_out is None:
        return acc[:n]
    acc[max(0, min(n_out, n - elem0)):] = 0.0
    return acc


def cohort_train_encode_step(client_update, hidden_flat, batches, k_train,
                             k_enc, *, b: int, bits=None,
                             member_chunk=None, taps: bool = False,
                             group=None, basis_seed=None,
                             residual=None, with_loss: bool = False,
                             chunk_rows=None, new_residual: bool = True,
                             mesh=None, stacked: bool = False):
    """The client pipeline of one cohort tier group (or of one client,
    b = 1): local SGD from the shared flat x-hat, then one encode launch
    over the members' (b, d) delta stack.

    ``client_update(hidden_flat, batches, key) -> (d,)`` is one member's
    flat delta (``core.qafel.client_update`` bound to its task). For b > 1,
    ``batches``, ``k_train`` and ``k_enc`` carry a leading member dim; the
    members train under one ``torch.func.vmap`` with x-hat shared, as the
    reference vmaps them (``jax.vmap(fn, in_axes=(None, 0, 0))``), and the
    stack is encoded by one K2 launch whose dither is the counter hash
    keyed by the first two words of each member's ``k_enc``. At b = 1 the
    inputs are unstacked and the upload is the threefry K1 launch of the
    sequential engine. ``member_chunk`` trains the members ``mc`` at a
    time (a Python loop of vmaps) and still encodes the stack in one
    launch. The encode's dither depends only on each member's seed and the
    element index, so chunking leaves the bits of a task whose per-member
    update is elementwise (the quad) as they are; the CNN's vmapped
    convolutions see another batch size, and its deltas move (up to
    1.2e-7 on the CPU, PERF.md). ``bits`` None is the identity quantizer
    and the sparse kinds, which are encoded after the step.

    A ``group`` makes it the lowrank upload: with the (b, d)
    error-feedback ``residual`` stack (None: zeros) and the round's (2,)
    ``basis_seed``, ``c = delta + residual`` is projected (the fused order
    of ``kernels.qsgd.sketch_project``), the (b, rank) subspace stack is
    encoded as above (K1 at b = 1, K2 above), decoded again (K3) and
    expanded, and ``residual = c - expand(decode)`` is each member's new
    residual, the expand's scale product fused into the subtraction
    (``fma(-(repeat(y) * sign), fl32(1/sqrt(group)), c)``, as XLA:CPU
    contracts the reference's jitted step). ``new_residual=False`` is a
    caller that never reads the new residual (the distributed round's
    fresh clients): its decode and expand are not formed unless ``taps``
    needs them, and ``"residual"`` is left out.

    Returns ``{"packed": (b, rows, 16*bits), "norms": (b, rows)}`` for
    qsgd (lowrank: over the rank coordinates, plus ``"residual"`` (b, d)),
    ``{"flat": (b, d)}`` for identity and the sparse kinds. ``taps=True``
    adds ``"taps"``, the (b, 2) upload taps of the stack
    (``kernels.taps.upload_taps``: one more launch; lowrank: the (b, 3)
    rows of ``lowrank_upload_taps``, two more).

    ``with_loss``: ``client_update`` returns ``(delta, losses)``, and so
    does this step: ``(out, losses)`` with the members' (b, P) losses
    ((P,) at b = 1).

    ``chunk_rows`` encodes ``chunk_rows`` wire rows at a time, each chunk
    keyed by its global row offset, so the codes are the unchunked
    encode's bit for bit. At b = 1 ``client_update(..., streamed=True)``
    hands back the delta as ``core.qafel.DeltaRows``, and a chunked qsgd
    upload without taps forms it chunk by chunk: the only whole-message
    outputs are then the codes and the norms.

    ``stacked``: the inputs carry a leading member dim even at b = 1, and
    the step is the cohort's (vmapped, K2 with the counter-hash dither)
    as for b > 1. With a ``mesh`` (``launch.mesh``) and b > 1 the members
    are index-padded to a multiple of the data extent D with copies of
    member 0 (``_index_pad_members``), each data rank trains and encodes
    its slice of ``ceil(b / D)`` members from the full x-hat it is given,
    and every output is gathered over the data ranks and cut back to b:
    each member's bits are the meshless step's (the dither keys on the
    member's seed and the element, never on the slice). Under a 2-D mesh
    every model rank of a data rank runs the same slice."""
    if mesh is not None and b > 1:
        return _cohort_step_on_mesh(
            client_update, hidden_flat, batches, k_train, k_enc, b=b,
            mesh=mesh, bits=bits, member_chunk=member_chunk, taps=taps,
            group=group, basis_seed=basis_seed, residual=residual,
            with_loss=with_loss, chunk_rows=chunk_rows,
            new_residual=new_residual)
    losses = None
    single = b == 1 and not stacked
    if single:
        delta = client_update(hidden_flat, batches, k_train, streamed=True)
        if with_loss:
            delta, losses = delta
        n = delta.n
        streamed = (chunk_rows is not None and bits is not None
                    and group is None and not taps)
        flat2d = None if streamed else delta.rows(0, n)[None]
    else:
        keys = to_device(torch.as_tensor(k_train), hidden_flat.device)
        step = torch.func.vmap(client_update, in_dims=(None, 0, 0))
        if member_chunk is None or member_chunk >= b:
            res = [step(hidden_flat, batches, keys)]
        else:
            mc = int(member_chunk)
            res = [step(hidden_flat, tree_map(lambda v: v[i:i + mc], batches),
                        keys[i:i + mc]) for i in range(0, b, mc)]
        if with_loss:
            losses = torch.cat([r[1] for r in res])
            res = [r[0] for r in res]
        flat2d = res[0] if len(res) == 1 else torch.cat(res)
        n = flat2d.shape[1]
    if group is not None:
        out = _lowrank_encode(flat2d, k_enc, bits, group, basis_seed,
                              residual, taps, chunk_rows, new_residual,
                              threefry=single)
    elif bits is None:
        out = _with_upload_taps({"flat": flat2d}, flat2d, bits, taps)
    else:
        rows_fn = ((lambda a, e: delta.rows(a, e)[None]) if flat2d is None
                   else (lambda a, e: flat2d[:, a:e]))
        packed, norms = _encode_stack(rows_fn, n, b, k_enc, bits, chunk_rows,
                                      hidden_flat.device, threefry=single)
        out = _with_upload_taps({"packed": packed, "norms": norms}, flat2d,
                                bits, taps)
    return (out, losses) if with_loss else out


def _index_pad_members(b: int, b_pad: int, batches, k_train, k_enc,
                       residual=None):
    """The member dim padded from b to b_pad by copies of member 0 (the
    caller cuts the padding's outputs off); the lowrank ``residual`` stack
    pads with the members."""
    if b_pad == b:
        return batches, k_train, k_enc, residual
    idx = torch.cat([torch.arange(b), torch.zeros(b_pad - b,
                                                  dtype=torch.int64)])
    take = lambda v: v[idx.to(v.device)]
    return (tree_map(take, batches), take(torch.as_tensor(k_train)),
            take(torch.as_tensor(k_enc)),
            None if residual is None else take(residual))


def _cohort_step_on_mesh(client_update, hidden_flat, batches, k_train, k_enc,
                         *, b: int, mesh, residual=None, with_loss=False,
                         **kw):
    """``cohort_train_encode_step`` with its members over the mesh's data
    ranks (its docstring)."""
    from repro_torch.launch.mesh import gather_members
    from repro_torch.sharding.rules import FLAT_AXIS, mesh_data_extent

    nd = mesh_data_extent(mesh)
    bl = -(-b // nd)
    batches, k_train, k_enc, residual = _index_pad_members(
        b, bl * nd, batches, k_train, k_enc, residual)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    i = int(coord[list(mesh.mesh_dim_names).index(FLAT_AXIS)])
    cut = lambda v: v[i * bl:(i + 1) * bl]
    res = cohort_train_encode_step(
        client_update, hidden_flat, tree_map(cut, batches), cut(k_train),
        cut(k_enc), b=bl, residual=None if residual is None else cut(
            residual), with_loss=with_loss, stacked=True, **kw)
    out, losses = res if with_loss else (res, None)
    out = {name: gather_members(v, mesh)[:b] for name, v in out.items()}
    if with_loss:
        return out, gather_members(losses, mesh)[:b]
    return out


def _encode_stack(rows_fn, n: int, b: int, k_enc, bits: int, chunk_rows,
                  device, threefry: bool):
    """The upload encode of a (b, n) stack whose ranges ``rows_fn(a, e)``
    gives: at b = 1 the threefry K1 of the sequential engine, above it one
    K2 launch whose dither is the counter hash keyed by the first two
    words of each member's key; with ``chunk_rows``, ``chunk_rows`` rows
    at a time (``qsgd_quantize_rows``)."""
    keys = k_enc if threefry else torch.as_tensor(k_enc).reshape(b, -1)[:, :2]
    if chunk_rows is not None:
        return qsgd_quantize_rows(rows_fn, n, keys, bits, chunk_rows,
                                  device=device, b=b, threefry=threefry)
    flat2d = rows_fn(0, n)
    if threefry:
        packed, norms = qsgd_quantize(flat2d[0], keys, bits)
        return packed[None], norms[None]
    return qsgd_quantize_batch(flat2d, keys, bits)


def _lowrank_encode(flat2d, k_enc, bits: int, group: int, basis_seed,
                    residual, taps: bool, chunk_rows=None,
                    new_residual: bool = True,
                    threefry=None) -> dict:
    """The lowrank half of ``cohort_train_encode_step``; ``threefry``
    (default: at one member) picks the b = 1 upload's encode."""
    from repro_torch.core.quantizers import (lowrank_expand_flat2d,
                                             lowrank_project_flat2d)

    if basis_seed is None:
        raise ValueError("a lowrank client step needs the round's basis "
                         "seed pair")
    d = flat2d.shape[1]
    if threefry is None:
        threefry = flat2d.shape[0] == 1
    c2d = flat2d if residual is None else flat2d + residual
    y2d = lowrank_project_flat2d(c2d, basis_seed, group)
    packed, norms = _encode_stack(lambda a, e: y2d[:, a:e], y2d.shape[1],
                                  y2d.shape[0], k_enc, bits, chunk_rows,
                                  y2d.device, threefry)
    out = {"packed": packed, "norms": norms}
    if not (new_residual or taps):
        return out
    qy2d = qsgd_dequantize_stack(packed, norms, bits, y2d.shape[1])
    # the expand's last product fused into the subtraction, as XLA:CPU
    # contracts it in the reference's jitted step: fma(-x, scale, c)
    x2d = lowrank_expand_flat2d(qy2d, basis_seed, group, d, scaled=False)
    res = fma_f32(-x2d, _qsgd.sketch_scale(group), c2d)
    if new_residual:
        out["residual"] = res
    if taps:
        out["taps"] = _taps.lowrank_upload_taps(
            c2d, res, y2d.contiguous(), packed, norms, bits)
    return out


def _with_upload_taps(out: dict, flat2d, bits, taps: bool) -> dict:
    """``out`` with its ``"taps"`` rows when ``taps`` is on: the delta
    stack against the decode of its own wire codes (identity: the delta
    is the wire, error 0)."""
    if taps:
        out["taps"] = _taps.upload_taps(flat2d.contiguous(), out.get("packed"),
                                        out.get("norms"), bits)
    return out


def server_apply_flat(x, momentum, delta, *, lr, beta):
    """The FedBuff server update (Algorithm 1 line 12 + server momentum):
    m <- beta m + Delta-bar; x <- x + eta_g m. Each product and sum is its
    own rounded operation, as the reference pins them. ``beta`` None
    disables momentum. Returns ``(x_new, momentum_new)``."""
    if beta is not None:
        momentum = beta * momentum + delta
    else:
        momentum = delta
    return lr * momentum + x, momentum


def server_flush_step(x_flat, hidden_flat, momentum_flat, stack, norms,
                      weights, extra, key2d, *, bits, sbits, n: int,
                      lr: float, beta, taps: bool = False, group=None,
                      lseeds=None):
    """The QAFeL buffer flush on the flat server state.

    1. fused dequantize-accumulate of the K packed uploads (plus the
       pre-scaled flat ``extra`` of identity arrivals),
    2. FedBuff server momentum and update (``server_apply_flat``),
    3. broadcast diff ``x^{t+1} - x-hat^t`` quantize-packed with the
       counter-hash dither keyed by ``key2d`` (``sbits``-bit qsgd), or the
       raw diff itself when ``sbits`` is None (identity server quantizer),
    4. hidden-state apply of the *decoded broadcast bits* — the exact
       increment every client replica applies.

    ``stack`` may be None (no packed uploads), ``beta`` None (no momentum).
    A lowrank window passes its sketch ``group`` and the (K, 2) per-upload
    basis seeds ``lseeds``: its rank-length stack is expanded by
    ``lowrank_window_delta`` and added behind ``extra`` (``extra + ld``)
    in place of step 1's aggregate; the chain after it is the same.
    Returns ``(x_new, hidden_new, momentum_new, payload)`` with payload
    ``(packed, norms)`` for a qsgd broadcast or ``(diff,)`` for identity.
    ``taps=True`` appends the (7,) flush tap vector
    (``kernels.taps.flush_taps``: one more launch) as a fifth element.
    """
    if group is not None:
        ld = lowrank_window_delta(stack, norms, weights, lseeds, bits=bits,
                                  group=group, n=n)
        extra = ld if extra is None else extra + ld
        stack = None
    if stack is not None:
        delta = buffer_aggregate(stack, norms, weights, bits, n)
        if extra is not None:
            delta = extra + delta
    else:
        delta = extra
    x_new, m_new = server_apply_flat(x_flat, momentum_flat, delta,
                                     lr=lr, beta=beta)
    diff = x_new - hidden_flat
    if sbits is None:  # identity server quantizer: the diff IS the payload
        q, payload = diff, (diff,)
    else:
        bp3, bn3 = qsgd_quantize_batch(diff[None], key2d, sbits)
        payload = (bp3[0], bn3[0])
        q = qsgd_dequantize(payload[0], payload[1], sbits, n)
    out = (x_new, hidden_flat + q, m_new, payload)
    if not taps:
        return out
    return out + (_taps.flush_taps(x_flat, x_new, delta, diff, q, weights),)


def flush_segment(x_l, h_l, m_l, stack_l, norms_l, weights, extra_l, key2d,
                  *, bits, sbits, lr: float, beta, seg: int, nseg: int,
                  n=None, chunk_rows=None, group=None, lseeds=None,
                  with_parts: bool = False):
    """``server_flush_step``'s chain on one segment of a flat state laid
    over ``nseg`` segments (``sharding.rules``): the segment's x, x-hat
    and m (``rows_l`` whole wire rows each), its rows of the (K, rows,
    16*bits) upload stack and norms and its slice of ``extra``, for
    segment index ``seg``. Every step is elementwise or rowwise, so each
    element gets the unsharded flush's bits: K4 on the segment's rows,
    the server update, K2 of the broadcast diff with its dither keyed on
    the global row ``seg * rows_l`` (``row0``), K3 of its codes and x-hat
    + q. No collective: a caller may run it for any segment.

    ``chunk_rows`` runs that chain on ``chunk_rows`` rows at a time, each
    chunk's K2 keyed on its own global row. A lowrank window (``group``,
    ``lseeds``) passes its whole rank-length stack: the segment's elements
    alone are expanded (``lowrank_window_delta(elem0=, n_out=)``, zero at
    the true length ``n`` and past it) and ride the ``extra`` lane.

    Returns the segment's ``(x_new, hidden_new, momentum_new, payload)``,
    payload ``(packed (rows_l, 16*sbits), norms (rows_l,))`` or ``(diff,)``
    for an identity broadcast; ``with_parts`` appends the segment's
    ``(delta, diff, q)`` for the flush taps."""
    n_l = x_l.shape[0]
    rows_l = n_l // LANES
    row0 = seg * rows_l
    if group is not None:
        if n is None:
            raise ValueError("a lowrank segment flush needs the true length "
                             "n (the padding must not be expanded)")
        ld = lowrank_window_delta(stack_l, norms_l, weights, lseeds,
                                  bits=bits, group=group, n=n,
                                  elem0=row0 * LANES, n_out=n_l)
        extra_l = ld if extra_l is None else extra_l + ld
        stack_l = None
    c = rows_l if chunk_rows is None else max(1, min(int(chunk_rows),
                                                     rows_l))
    x_new, h_new, m_new = (torch.empty_like(v) for v in (x_l, h_l, m_l))
    parts = [torch.empty_like(x_l) for _ in range(3)] if with_parts else None
    if sbits is None:
        payload = (torch.empty_like(x_l),)
    else:
        payload = (torch.empty((rows_l, 16 * sbits), dtype=torch.uint8,
                               device=x_l.device),
                   torch.empty(rows_l, dtype=torch.float32,
                               device=x_l.device))
    for r0 in range(0, rows_l, c):
        r1 = min(rows_l, r0 + c)
        a, b = r0 * LANES, r1 * LANES
        ex = None if extra_l is None else extra_l[a:b]
        if stack_l is not None:
            delta = buffer_aggregate(stack_l[:, r0:r1].contiguous(),
                                     norms_l[:, r0:r1].contiguous(), weights,
                                     bits, b - a)
            if ex is not None:
                delta = ex + delta
        else:
            delta = ex
        xc, mc = server_apply_flat(x_l[a:b], m_l[a:b], delta, lr=lr,
                                   beta=beta)
        diff = xc - h_l[a:b]
        if sbits is None:
            q = diff
            payload[0][a:b] = diff
        else:
            bp, bn = _qsgd.qsgd_quantize_pack_batch(
                diff.reshape(1, r1 - r0, LANES), key2d, sbits, row0=row0 + r0)
            payload[0][r0:r1], payload[1][r0:r1] = bp[0], bn[0]
            q = _qsgd.qsgd_unpack_dequantize(bp[0], bn[0], sbits).reshape(-1)
        x_new[a:b], m_new[a:b] = xc, mc
        h_new[a:b] = h_l[a:b] + q
        if parts is not None:
            for dst, v in zip(parts, (delta, diff, q)):
                dst[a:b] = v
    out = (x_new, h_new, m_new, payload)
    return out + (tuple(parts),) if with_parts else out


def server_flush_step_sharded(x_l, h_l, m_l, stack_l, norms_l, weights,
                              extra_l, key2d, *, bits, sbits, lr: float,
                              beta, mesh, n=None, taps: bool = False,
                              chunk_rows=None, group=None, lseeds=None):
    """``server_flush_step`` on a flat state laid over ``mesh``'s flat
    segments, run on every rank of it: ``flush_segment`` on this rank's
    segment (``sharding.rules.flat_segment_index``). The only collective
    is the taps': with ``taps=True`` (which needs the true length ``n``)
    x, x_new, delta, diff and q are gathered over the flat group, cut to
    the true n and given to the one ``kernels.taps.flush_taps``, so the
    taps are the unsharded flush's on every mesh. Returns the segment's
    ``(x_new, hidden_new, momentum_new, payload)`` and with taps the (7,)
    tap vector."""
    from repro_torch.launch.mesh import gather_segments
    from repro_torch.sharding.rules import flat_segment_index, \
        mesh_flat_extent

    if taps and n is None:
        raise ValueError("server_flush_step_sharded(taps=True) needs the "
                         "true length n")
    out = flush_segment(x_l, h_l, m_l, stack_l, norms_l, weights, extra_l,
                        key2d, bits=bits, sbits=sbits, lr=lr, beta=beta,
                        seg=flat_segment_index(mesh),
                        nseg=mesh_flat_extent(mesh), n=n,
                        chunk_rows=chunk_rows, group=group, lseeds=lseeds,
                        with_parts=taps)
    if not taps:
        return out
    full = [gather_segments(v, mesh)[:n] for v in (x_l, out[0], *out[4])]
    return out[:4] + (_taps.flush_taps(*full, weights),)


# ---------------------------------------------------------------------------
# The population lifecycle step
# ---------------------------------------------------------------------------


def population_advance(pop, seeds, version, draws=None, *, admitting: bool,
                       scenario, capacity: int, buckets: int,
                       bucket_width: int, admit: int, deliver: int,
                       queue_cap: int):
    """Advance the device-resident population by one macro step.

    Either admits a cohort of ``admit`` clients (drawing their
    interarrivals, latencies, dropouts and tiers on the device from the
    counter-hash law, or taking the host-fed ``draws`` dict ``{"inter",
    "dur", "drop", "tier"}`` of ``(admit,)`` arrays) or pops up to
    ``deliver`` completed deadlines in completion order; ``admitting`` is
    the branch, the last step's ``will_admit`` (True on a fresh
    population). The state tensors of ``pop`` (``population
    .init_population``) are updated in place, the port's counterpart of
    the reference's donation. ``version`` is the server's model version
    (staleness = version - the slot's start version).

    Returns the packed step output (``population.PackedStepOut``: an f32
    and an i32 flat tensor, views of one buffer); the host reads it with
    one device-to-host copy through ``population.PopStepOut``. The
    ``buckets`` of the wheel are ``pop["deadline"]``'s rows, taken for the
    reference's signature."""
    from repro_torch.kernels import population as _pop
    if pop["deadline"].shape != (buckets, bucket_width):
        raise ValueError(f"wheel {tuple(pop['deadline'].shape)} is not "
                         f"{buckets}x{bucket_width}")
    if deliver > capacity:
        raise ValueError(f"deliver batch {deliver} > capacity {capacity}")
    if draws is not None:
        dev = pop["deadline"].device
        dtypes = {"inter": torch.float32, "dur": torch.float32,
                  "drop": torch.bool, "tier": torch.int32}
        draws = {k: to_device(torch.as_tensor(draws[k]).to(dt), dev)
                 for k, dt in dtypes.items()}
    out = _pop.advance(pop, seeds, version, draws, admitting=admitting,
                       scn=scenario, bucket_width=bucket_width, admit=admit,
                       deliver=deliver, queue_cap=queue_cap)
    return _pop.pack_step_out(out, admit, deliver)
