"""The index build's stages as torch programs (the write path on the card).

This package's counterpart of the JAX package's `index/device_build.py`.
Each function takes torch tensors on one explicit device, runs the same on
CUDA and CPU tensors, and returns exactly what the host route of
`index.pack.PackBuilder` computes, bit for bit (tests/test_torch_device_build.py):

- `tokenize_hash_stream`: the `standard` analyzer's tokenizer on a burst's
  flat byte stream (its values joined, a value boundary ending a token),
  with two polynomial hash lanes per token (multipliers 1000003 and 8191,
  mod 2^32) over the lowercased bytes. No [values, chars] padding, so a
  burst of a million documents stays one pass on the card.
  `analyze_hash_device` is the reference's padded-input form of it;
- `flat_csr_device`: postings as the sorted unique (term id, doc) keys and
  their counts; `sort_positions_device`: the position keys ordered per term
  by a stable sort;
- `csr_blocked_scatter_device`: the flat lanes scattered into their
  [total_blocks, BLOCK] rows, per-block max-tf and min-len by scatter
  amax / amin (exact, order-free);
- `postings_device`, `position_blocks_device`, `impact_codes_device`,
  `dense_tier_device`: the blocked postings, position blocks, impact codes
  and the dense tier's tf / (tf + K) rows (K in f64, rounded to f32 once).

The k-means and the ANN tiles already run on the card (`ops.vector.kmeans_ivf`,
`ann.index.ann_tiles`).

`use_device_build(elements, device)` routes a stage: the card only, and
only at or above the stage's element floor (`DEVICE_BUILD_MIN` elements
for a build stage, `ANALYZE_DEVICE_MIN` bytes of a burst for analysis), as
the reference's floors do. Below them, and on the CPU, the host route runs.
No environment variable changes the route; tests force it by replacing
`use_device_build`. A stage that fails on the card raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# the reference's floors (`device_build.py:79-96`, `analysis/batched.py:69`)
DEVICE_BUILD_MIN = 32768  # elements of one build stage
ANALYZE_DEVICE_MIN = 1 << 16  # bytes of one analysis burst

HASH_MULT_1 = 1000003
HASH_MULT_2 = 8191
_MASK32 = (1 << 32) - 1
_APOSTROPHE = 39


def use_device_build(elements: int, device, floor: int | None = None) -> bool:
    """A stage of `elements` runs on the card: `device` is CUDA and the
    stage reaches `floor` (None: DEVICE_BUILD_MIN)."""
    floor = DEVICE_BUILD_MIN if floor is None else floor
    return (device is not None and torch.device(device).type == "cuda"
            and int(elements) >= floor)


def as_device(a, device, dtype=None) -> torch.Tensor:
    """numpy or tensor -> a tensor on `device` (no copy when already there)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


def as_host(a) -> np.ndarray:
    """tensor or numpy -> numpy (a host tensor's memory is shared)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return a


# ---------------------------------------------------------------------------
# analysis: tokenize and hash a flat byte stream
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _powers(mult: int, n: int) -> np.ndarray:
    """[n] int64: mult^j mod 2^32."""
    out = np.empty(max(n, 1), np.uint64)
    out[0] = 1
    for j in range(1, len(out)):
        out[j] = (int(out[j - 1]) * mult) & _MASK32
    return out.astype(np.int64)


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 a, b in [0, 2^32), with no int64 overflow."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _char_classes(c: torch.Tensor, first: torch.Tensor, last: torch.Tensor):
    """-> (lowered bytes, joiner, in-token, start, end) over a byte stream
    whose values begin at `first` and end at `last` (bool masks)."""
    lower = torch.where((c >= 65) & (c <= 90), c + 32, c)
    is_word = ((lower >= 97) & (lower <= 122)) | ((c >= 48) & (c <= 57))

    def before(m):  # m at i - 1, False at a value's first byte
        out = torch.zeros_like(m)
        out[1:] = m[:-1]
        return out & ~first

    def after(m):  # m at i + 1, False at a value's last byte
        out = torch.zeros_like(m)
        out[:-1] = m[1:]
        return out & ~last

    # the `standard` tokenizer's apostrophe join: 0x27 between word chars
    joiner = (c == _APOSTROPHE) & before(is_word) & after(is_word)
    in_tok = is_word | joiner
    start = in_tok & ~before(in_tok)
    end = in_tok & ~after(in_tok)
    return lower, joiner, in_tok, start, end


def _token_hashes(lower, in_tok, starts, ends, tok_of, mult: int, running: bool):
    """Per token, sum_i lower_i * mult^(end - i) mod 2^32 (the reference's
    segmented rolling hash at the token's end), as an int64 cumsum of
    contributions masked to 32 bits, differenced at the token bounds. With
    `running`, also each in-token byte's prefix hash (the value the
    reference's scan holds there)."""
    n = lower.shape[0]
    dev = lower.device
    max_len = int((ends - starts).max()) + 1 if starts.numel() else 1
    powers = torch.from_numpy(_powers(mult, max_len)).to(dev)
    tok = tok_of.clamp(min=0)
    dist = (ends[tok] - torch.arange(n, device=dev)).clamp(0, max_len - 1) if starts.numel() \
        else torch.zeros(n, dtype=torch.int64, device=dev)
    contrib = torch.where(in_tok, (lower.to(torch.int64) * powers[dist]) & _MASK32, 0)
    cs = torch.cumsum(contrib, 0)
    cs0 = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), cs])
    h = (cs0[ends + 1] - cs0[starts]) & _MASK32
    if not running:
        return h, None
    inv_powers = torch.from_numpy(_powers(pow(mult, -1, 1 << 32), max_len)).to(dev)
    prefix = (cs0[1:] - cs0[starts[tok]]) & _MASK32 if starts.numel() else cs
    run = _mulmod32(prefix, inv_powers[dist])
    return h, torch.where(in_tok, run, 0)


def tokenize_hash_stream(stream: torch.Tensor, offsets: torch.Tensor,
                         mults: tuple[int, int] = (HASH_MULT_1, HASH_MULT_2),
                         running: bool = False) -> dict:
    """Tokenize a flat uint8 stream of ASCII values (value v is
    stream[offsets[v]:offsets[v+1]]) as the `standard` tokenizer does, and
    hash each token's lowercased bytes in two lanes.

    -> {"start", "end" (inclusive), "value", "njoin", "h1", "h2"}: int64
    [T] per token in stream order (njoin counts the apostrophe joins in
    it), and the byte masks "joiner", "in_tok", "start_mask", "end_mask";
    with `running`, "run1", "run2": each in-token byte's prefix hash."""
    dev = stream.device
    n = stream.shape[0]
    lens = offsets[1:] - offsets[:-1]
    nonempty = lens > 0
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    last = torch.zeros(n, dtype=torch.bool, device=dev)
    first[offsets[:-1][nonempty]] = True
    last[offsets[1:][nonempty] - 1] = True
    lower, joiner, in_tok, start_m, end_m = _char_classes(stream, first, last)
    starts = torch.nonzero(start_m).flatten()
    ends = torch.nonzero(end_m).flatten()
    tok_of = torch.cumsum(start_m, 0, dtype=torch.int64) - 1
    jcum = torch.cumsum(joiner, 0, dtype=torch.int64)
    out = {"start": starts, "end": ends,
           "value": torch.searchsorted(offsets[1:].contiguous(), starts, right=True),
           "njoin": jcum[ends] - jcum[starts],  # a token never starts with a joiner
           "joiner": joiner, "in_tok": in_tok, "start_mask": start_m, "end_mask": end_m}
    for lane, mult in zip(("1", "2"), mults):
        h, run = _token_hashes(lower, in_tok, starts, ends, tok_of, mult, running)
        out["h" + lane] = h
        if running:
            out["run" + lane] = run
    return out


def analyze_hash_device(chars, lengths, device="cpu",
                        mults: tuple[int, int] = (HASH_MULT_1, HASH_MULT_2)):
    """The reference's `analyze_hash_device` on a padded [B, L] uint8 input:
    -> (start, end, joiner, h1, h2) numpy [B, L], equal to the reference's
    (h at every position: the running hash inside a token, the last token's
    hash carried past it within the row, 0 before the row's first token).
    Runs `tokenize_hash_stream` on the rows' valid bytes."""
    chars = np.asarray(chars, np.uint8)
    lengths = np.asarray(lengths, np.int64)
    B, L = chars.shape
    valid = np.arange(L)[None, :] < lengths[:, None]
    stream = as_device(chars[valid], device)
    offsets = as_device(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64), device)
    r = tokenize_hash_stream(stream, offsets, mults, running=True)
    flat_pos = torch.from_numpy(np.flatnonzero(valid.ravel())).to(stream.device)

    def to_grid(v, fill=0):
        grid = torch.full((B * L,), fill, dtype=v.dtype, device=stream.device)
        grid[flat_pos] = v
        return grid

    outs = [to_grid(r[k]) for k in ("start_mask", "end_mask", "joiner")]
    # carry: the index of the last token end at or before each position of
    # its row (-1: none yet)
    row0 = torch.arange(B * L, device=stream.device) // L * L
    end_grid = to_grid(r["end_mask"])
    idx = torch.where(end_grid, torch.arange(B * L, device=stream.device), -1)
    last_end = torch.cummax(idx, 0).values
    last_end = torch.where(last_end >= row0, last_end, -1)
    in_grid = to_grid(r["in_tok"])
    for lane in ("run1", "run2"):
        run = to_grid(r[lane])
        carried = torch.where(last_end >= 0, run[last_end.clamp(min=0)], 0)
        outs.append(torch.where(in_grid, run, carried).to(torch.int64))
    start, end, joiner, h1, h2 = (o.reshape(B, L).cpu().numpy() for o in outs)
    return start, end, joiner, h1.astype(np.uint32), h2.astype(np.uint32)


# ---------------------------------------------------------------------------
# the flat CSR and the blocked postings
# ---------------------------------------------------------------------------

def flat_csr_device(tids: torch.Tensor, docs: torch.Tensor, N: int, T: int):
    """Tokens (term id, doc) -> (flat_docs int32, flat_tfs f32, df int64
    [T]): each term's postings docid-ascending, terms in id order, as
    `np.unique(tid * N + doc, return_counts=True)` gives them."""
    uk, tf = torch.unique(tids * N + docs, sorted=True, return_counts=True)
    tid = torch.div(uk, N, rounding_mode="floor")
    return ((uk - tid * N).to(torch.int32), tf.to(torch.float32),
            torch.bincount(tid, minlength=T))


def sort_positions_device(ptid: torch.Tensor, pkeys: torch.Tensor, T: int):
    """Position keys in (doc, position) stream order -> (keys ordered by
    term id, stably; positions per term [T])."""
    order = torch.sort(ptid, stable=True).indices
    return pkeys[order], torch.bincount(ptid, minlength=T)


def _dest(counts: torch.Tensor, offsets: torch.Tensor, row_base: torch.Tensor, block: int):
    """Flat lane -> (block row, column) of a segment scatter: segment t's
    lanes fill rows row_base[t]... in order."""
    T = counts.shape[0]
    n = int(offsets[-1])
    seg = torch.repeat_interleave(torch.arange(T, device=counts.device), counts, output_size=n)
    local = torch.arange(n, device=counts.device) - offsets[:-1][seg]
    return seg, row_base[:-1][seg] + torch.div(local, block, rounding_mode="floor"), local % block


def csr_blocked_scatter_device(flat_docs, flat_tfs, flat_dls, dest_row, dest_col,
                               total_blocks: int, block: int, n_sentinel: int):
    """Flat CSR lanes into [total_blocks, block] rows, with each block's max
    tf and min doc length by scatter amax / amin (exact and order-free, as
    the host reduceat). -> (post_docids, post_tfs, post_dls, block_max_tf,
    block_min_len) tensors; min-len stays +inf for an empty block (the
    caller maps it to 1.0, as the host route does)."""
    dev = flat_docs.device
    flat = dest_row * block + dest_col
    docids = torch.full((total_blocks * block,), n_sentinel, dtype=torch.int32, device=dev)
    tfs = torch.zeros(total_blocks * block, dtype=torch.float32, device=dev)
    dls = torch.ones(total_blocks * block, dtype=torch.float32, device=dev)
    docids[flat] = flat_docs
    tfs[flat] = flat_tfs
    dls[flat] = flat_dls
    bmax = torch.zeros(total_blocks, dtype=torch.float32, device=dev)
    bmin = torch.full((total_blocks,), float("inf"), dtype=torch.float32, device=dev)
    bmax.scatter_reduce_(0, dest_row, flat_tfs, "amax")
    bmin.scatter_reduce_(0, dest_row, flat_dls, "amin")
    return (docids.view(total_blocks, block), tfs.view(total_blocks, block),
            dls.view(total_blocks, block), bmax, bmin)


def postings_device(flat_docs, flat_tfs, post_offsets, row_base, field_of_term,
                    norm_of_field: dict, N: int, block: int):
    """The blocked postings of `PackBuilder.build` on the flat CSR's device:
    each posting's doc length (its field's norm, 1.0 for a norm-less field)
    and the segment scatter. -> (post_docids, post_tfs, post_dls,
    block_max_tf, block_min_len, term_of_post, post_dl_flat)."""
    dev = flat_docs.device
    df = post_offsets[1:] - post_offsets[:-1]
    term_of_post, dest_row, dest_col = _dest(df, post_offsets, row_base, block)
    post_dl = torch.ones(flat_docs.shape[0], dtype=torch.float32, device=dev)
    fop = field_of_term[term_of_post]
    for code, nrm in norm_of_field.items():
        sel = torch.nonzero(fop == code).flatten()
        post_dl[sel] = nrm[flat_docs[sel].long()]
    out = csr_blocked_scatter_device(flat_docs, flat_tfs, post_dl, dest_row, dest_col,
                                     int(row_base[-1]), block, N)
    return (*out, term_of_post, post_dl)


def position_blocks_device(flat_pos, pos_offsets, prow_base, block: int, pad: int):
    """Position keys into [rows, block] blocks, `pad` behind them."""
    pos_df = pos_offsets[1:] - pos_offsets[:-1]
    _t, row, col = _dest(pos_df, pos_offsets, prow_base, block)
    rows = int(prow_base[-1])
    out = torch.full((rows * block,), pad, dtype=torch.int64, device=flat_pos.device)
    out[row * block + col] = flat_pos
    return out.view(rows, block)


# ---------------------------------------------------------------------------
# impact codes and the dense tier
# ---------------------------------------------------------------------------

CODE_DTYPES = {"uint16": torch.uint16, "int8": torch.int8}


def impact_codes_device(tfs, dls, k_base, k_slope, scale_inv, *, qmax: int, dtype: str):
    """The quantized impact codes from blocked postings, in the f32
    operations of `index.pack.impact_codes_host` (byte-equal to it). Per-row
    parameters [..., nb] broadcast against blocked lanes [..., nb, BLOCK]."""
    K = k_base[..., None] + k_slope[..., None] * dls
    tfn = tfs / (tfs + K)  # tf == 0 padding -> 0
    q = torch.round(tfn * scale_inv[..., None])
    q = torch.clamp(q, 1, qmax)  # tf > 0 must stay a match (code >= 1)
    q = torch.where(tfs > 0, q, 0.0).to(torch.int32)
    if dtype == "uint16":  # few uint16 ops exist: write the bits through int16
        return torch.where(q > 32767, q - 65536, q).to(torch.int16).view(torch.uint16)
    return q.to(CODE_DTYPES[dtype])


def dense_tier_device(dense_rank, term_of_post, flat_docs, flat_tfs, post_dl, field_of_term,
                      has_norms_of_field, avgdl_of_field, N: int, rows: int,
                      k1: float, b: float) -> torch.Tensor:
    """[rows, N] f32 tf / (tf + K) rows of the dense terms (`dense_rank` [T]:
    a term's row, -1 outside the tier), K = k1 * (1 - b + b * dl / avgdl)
    in f64 (k1 for a norm-less field), rounded to f32 once, in the
    operations of the host route."""
    dev = flat_docs.device
    tier = torch.zeros((rows, N), dtype=torch.float32, device=dev)
    rank = dense_rank[term_of_post]
    sel = torch.nonzero(rank >= 0).flatten()
    tfs = flat_tfs[sel].double()
    fcode = field_of_term[term_of_post[sel]]
    # b * dl in f32, as numpy multiplies an f32 array by a Python float
    dl_term = (b * post_dl[sel]).double() / avgdl_of_field[fcode]
    K = torch.where(has_norms_of_field[fcode], k1 * ((1.0 - b) + dl_term),
                    torch.tensor(k1, dtype=torch.float64, device=dev))
    tier[rank[sel], flat_docs[sel].long()] = (tfs / (tfs + K)).to(torch.float32)
    return tier
