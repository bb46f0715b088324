"""Batched text analysis: a burst of values analyzed at once.

This package's copy of the JAX package's `analysis/batched.py`. For the
`standard` analyzer, three paths, all equal to the oracle
`StandardAnalyzer.analyze` (same terms, same positions, same token counts
per value):

- the host oracle: `analyze` per value;
- the batched host path: one `findall` per value, no Token objects;
- the device path: the burst's eligible values (non-empty ASCII, at most
  `_DEVICE_VALUE_CAP` characters) joined into one byte stream on a torch
  device, tokenized and hashed there (`index.device_build.tokenize_hash_stream`).
  Tokens group by (h1, h2, length); one representative string per group is
  sliced on the host (vocabulary-sized work), and every token's bytes are
  compared with its representative's on the device. A value with a token
  that differs from its representative, a token over 255 characters or a
  token with more than one apostrophe join takes the batched host path,
  value by value, so two different terms never share an id (the JAX
  package merges colliding terms; see ROADMAP queue C). The device path's
  tokens stay on the device: term ids into a vocabulary list, value index
  and within-value position.

Any other analyzer (a built-in one, or a custom chain with synonyms,
n-grams or shingles) takes the host oracle, value by value: the route is
chosen by the analyzer's type (`BatchedAnalyzer.route`), and the
`build.analyze` stage records it as its basis, "host_analyzer".

`analyze_burst` chains a burst's values into documents with the +100
multi-value position gap, as `PackBuilder.add_document` does, under one
`build.analyze` stage. The route: `mode` "host", "batched" or "device", or
None: the device path when `index.device_build.use_device_build` admits the
burst's bytes on the builder's device (the card, at least
`ANALYZE_DEVICE_MIN` bytes), the batched host path otherwise.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass

import numpy as np
import torch

from .analyzers import _WORD_RE, Analyzer, StandardAnalyzer

# a longer value takes the host path even on the device route
_DEVICE_VALUE_CAP = 8192
# the longest token the device path emits (the analyzer's default cap)
_DEVICE_TOKEN_CAP = 255
# bytes of the stream tokenized per step (bounds the device temporaries)
_STREAM_CHUNK = 1 << 27
# token bytes compared with their representatives per step
_VERIFY_CHUNK = 1 << 27


def _empty_i64() -> np.ndarray:
    return np.empty(0, np.int64)


def _obj_array(items: list) -> np.ndarray:
    arr = np.empty(len(items), object)
    if items:
        arr[:] = items
    return arr


@dataclass
class ValueTokens:
    """The flat token streams of one burst of values, value-major (the
    oracle's emission order). The host paths give `terms`; the device path
    gives `term_ids` into `vocab` and keeps its arrays on its device."""

    terms: np.ndarray | None  # object [T] emitted terms (host paths)
    value_idx: np.ndarray | torch.Tensor  # int64 [T] index into the burst's values
    pos_pre: np.ndarray | torch.Tensor  # int64 [T] within-value position
    last_pos: np.ndarray | torch.Tensor  # int64 [V] largest position per value (-1: none)
    counts: np.ndarray | torch.Tensor  # int64 [V] tokens per value
    basis: str  # "host" | "device"
    term_ids: torch.Tensor | None = None  # int64 [T] (device path)
    vocab: list | None = None  # term id -> term (device path)

    def term_strings(self) -> np.ndarray:
        """object [T]: the terms, whichever path made them."""
        if self.terms is not None:
            return self.terms
        return _obj_array(self.vocab)[self.term_ids.cpu().numpy()]


@dataclass
class BurstResult:
    """Per-document token streams of one burst of documents."""

    terms: np.ndarray | None  # object [T] (host paths)
    doc_idx: np.ndarray | torch.Tensor  # int64 [T] index into the burst's docs
    positions: np.ndarray | torch.Tensor  # int64 [T] within-doc positions
    lengths: np.ndarray  # int64 [D] tokens per doc (the field-length norm)
    basis: str
    term_ids: torch.Tensor | None = None
    vocab: list | None = None

    term_strings = ValueTokens.term_strings


class BatchedAnalyzer:
    """Batched counterpart of one analyzer; holds no per-burst state, so
    `FieldType.get_batched_analyzer` memoizes it."""

    def __init__(self, analyzer: Analyzer):
        self.analyzer = analyzer
        self.stopwords = analyzer.stopwords
        self.max_token_length = int(analyzer.max_token_length)
        # `standard` has the batched and device paths; every other analyzer
        # runs its own chain per value on the host (the oracle)
        self.route = "standard" if type(analyzer) is StandardAnalyzer else "host_analyzer"
        # the device path is plain `standard`: no stopwords, the default cap
        self.device_eligible = (self.route == "standard" and not analyzer.stopwords
                                and self.max_token_length == _DEVICE_TOKEN_CAP)

    # ---- one value -------------------------------------------------------

    def _oracle_value(self, v: str):
        toks = self.analyzer.analyze(v)
        if not toks:
            return [], _empty_i64(), -1
        pos = np.fromiter((t.position for t in toks), np.int64, count=len(toks))
        return [t.term for t in toks], pos, int(pos[-1])

    def _fast_value(self, v: str):
        """One regex pass; a value with an overlong token takes the oracle
        (its split changes the positions)."""
        toks = _WORD_RE.findall(unicodedata.normalize("NFC", v))
        if not toks:
            return [], _empty_i64(), -1
        if max(map(len, toks)) > self.max_token_length:
            return self._oracle_value(v)
        toks = list(map(str.lower, toks))
        n = len(toks)
        if self.stopwords:
            keep = np.fromiter((t not in self.stopwords for t in toks), np.bool_, count=n)
            if not keep.all():
                pos = np.flatnonzero(keep).astype(np.int64)
                if pos.size == 0:
                    return [], _empty_i64(), -1
                return [t for t, k in zip(toks, keep) if k], pos, int(pos[-1])
        return toks, np.arange(n, dtype=np.int64), n - 1

    # ---- a burst of values -----------------------------------------------

    def analyze_values(self, values: list[str], mode: str = "batched",
                       device=None) -> ValueTokens:
        """All values of one burst -> flat token streams: `mode` "host" (the
        oracle per value), "batched" (one regex pass per value) or "device"
        (the device path on `device`, the CPU when None; an analyzer with
        stopwords or another length cap runs batched)."""
        if mode == "device" and self.device_eligible and values:
            out = self._device_values(values, torch.device(device or "cpu"))
            if out is not None:
                return out
        one = (self._oracle_value if mode == "host" or self.route != "standard"
               else self._fast_value)
        V = len(values)
        flat: list[str] = []
        pos_parts: list[np.ndarray] = []
        last_pos = np.full(V, -1, np.int64)
        counts = np.zeros(V, np.int64)
        for i, v in enumerate(values):
            terms, pos, lp = one(v)
            if terms:
                flat.extend(terms)
                pos_parts.append(pos)
                counts[i] = len(terms)
                last_pos[i] = lp
        return ValueTokens(
            terms=_obj_array(flat),
            value_idx=np.repeat(np.arange(V, dtype=np.int64), counts),
            pos_pre=np.concatenate(pos_parts) if pos_parts else _empty_i64(),
            last_pos=last_pos, counts=counts, basis="host")

    # ---- the device path -------------------------------------------------

    def _device_values(self, values: list[str], device: torch.device) -> ValueTokens | None:
        from ..index.device_build import HASH_MULT_1, HASH_MULT_2, tokenize_hash_stream

        V = len(values)
        lens_all = np.fromiter(map(len, values), np.int64, count=V)
        joined = "".join(values)
        if joined.isascii():
            ok = (lens_all > 0) & (lens_all <= _DEVICE_VALUE_CAP)
        else:
            ok = np.fromiter((0 < len(v) <= _DEVICE_VALUE_CAP and v.isascii() for v in values),
                             np.bool_, count=V)
        idx_dev = np.flatnonzero(ok)
        if idx_dev.size == 0:
            return None
        if idx_dev.size < V:
            joined = "".join([values[i] for i in idx_dev])
        raw = joined.encode("ascii")
        lens = lens_all[idx_dev]
        Vd = len(idx_dev)
        offsets_np = np.zeros(Vd + 1, np.int64)
        np.cumsum(lens, out=offsets_np[1:])
        stream = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)
        offsets = torch.from_numpy(offsets_np).to(device)

        # ---- tokenize and hash, a chunk of whole values at a time
        parts = {k: [] for k in ("start", "end", "value", "njoin", "h1", "h2")}
        v0 = 0
        while v0 < Vd:
            v1 = int(np.searchsorted(offsets_np, offsets_np[v0] + _STREAM_CHUNK, "right")) - 1
            v1 = min(max(v1, v0 + 1), Vd)
            b0, b1 = int(offsets_np[v0]), int(offsets_np[v1])
            r = tokenize_hash_stream(stream[b0:b1], offsets[v0:v1 + 1] - b0,
                                     (HASH_MULT_1, HASH_MULT_2))
            for k, shift in (("start", b0), ("end", b0), ("value", v0), ("njoin", 0),
                             ("h1", 0), ("h2", 0)):
                parts[k].append(r[k] + shift)
            del r
            v0 = v1
        tok = {k: torch.cat(v) for k, v in parts.items()}
        del parts
        start, value = tok["start"], tok["value"]
        tok_len = tok["end"] - start + 1
        # a value with a token the regex would split (two joins) or the
        # analyzer would cut (overlong) takes the host path
        bad_value = torch.zeros(Vd, dtype=torch.bool, device=device)
        bad_value[value[(tok["njoin"] > 1) | (tok_len > _DEVICE_TOKEN_CAP)]] = True

        # ---- group by (h1, h2, length); verify every token's bytes
        good = torch.nonzero(~bad_value[value]).flatten()
        key = ((tok["h1"][good] ^ (tok_len[good] << 24)) << 31) ^ tok["h2"][good]
        _uniq, group = torch.unique(key, return_inverse=True)
        G = int(_uniq.shape[0])
        del _uniq, key
        rep = torch.full((G,), good.shape[0], dtype=torch.int64, device=device)
        rep.scatter_reduce_(0, group, torch.arange(good.shape[0], device=device), "amin")
        rep_tok = good[rep[group]]  # the representative token of each good token
        differs = tok_len[rep_tok] != tok_len[good]
        lower = torch.where((stream >= 65) & (stream <= 90), stream + 32, stream)
        glen = torch.where(differs, 0, tok_len[good])
        gcum = torch.cumsum(glen, 0)
        t0 = 0
        while t0 < good.shape[0]:
            limit = torch.tensor([int(gcum[t0] - glen[t0]) + _VERIFY_CHUNK], device=device)
            t1 = int(torch.searchsorted(gcum, limit, right=True)[0])
            t1 = min(max(t1, t0 + 1), good.shape[0])
            ln = glen[t0:t1]
            n_bytes = int(ln.sum())
            if n_bytes:
                owner = torch.repeat_interleave(torch.arange(t0, t1, device=device), ln,
                                                output_size=n_bytes)
                base = gcum[owner] - glen[owner]
                off = torch.arange(n_bytes, device=device) + (gcum[t0] - glen[t0]) - base
                ne = lower[start[good[owner]] + off] != lower[start[rep_tok[owner]] + off]
                differs[owner[ne]] = True
            t0 = t1
        bad_value[value[good[differs]]] = True
        del lower, glen, gcum

        # ---- the device tokens: values with no bad token
        keep = torch.nonzero(~bad_value[value[good]]).flatten()
        surv = good[keep]
        used, term_ids = torch.unique(group[keep], return_inverse=True)
        reps = good[rep[used]]
        rs = start[reps].cpu().numpy()
        rl = tok_len[reps].cpu().numpy()
        vocab = [raw[s:s + n].lower().decode("ascii") for s, n in zip(rs.tolist(), rl.tolist())]
        val_dev = value[surv]
        first_tok = torch.searchsorted(val_dev, val_dev)
        pos_pre = torch.arange(val_dev.shape[0], device=device) - first_tok
        idx_dev_t = torch.from_numpy(idx_dev).to(device)
        value_idx = idx_dev_t[val_dev]
        counts = torch.zeros(V, dtype=torch.int64, device=device)
        counts[idx_dev_t] = torch.bincount(val_dev, minlength=Vd)
        # ---- the host path for the other values, merged in value order
        fb = ~ok
        fb[idx_dev[bad_value.cpu().numpy()]] = True
        fb_idx = np.flatnonzero(fb)
        if fb_idx.size:
            id_of = {t: i for i, t in enumerate(vocab)}
            fb_terms, fb_vals, fb_pos = [], [], []
            fb_counts = np.zeros(fb_idx.size, np.int64)
            for j, i in enumerate(fb_idx.tolist()):
                terms, pos, _lp = self._fast_value(values[i])
                fb_counts[j] = len(terms)
                fb_terms.extend(terms)
                fb_pos.append(pos)
            for t in fb_terms:
                if t not in id_of:
                    id_of[t] = len(vocab)
                    vocab.append(t)
            fb_vals = np.repeat(fb_idx.astype(np.int64), fb_counts)
            put = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)  # noqa: E731
            fb_ids = put(np.fromiter(map(id_of.__getitem__, fb_terms), np.int64,
                                     count=len(fb_terms)))
            fb_posa = np.concatenate(fb_pos) if fb_pos else _empty_i64()
            counts[put(fb_idx)] = put(fb_counts)
            value_idx = torch.cat([value_idx, put(fb_vals)])
            order = torch.sort(value_idx, stable=True).indices
            value_idx = value_idx[order]
            term_ids = torch.cat([term_ids, fb_ids])[order]
            pos_pre = torch.cat([pos_pre, put(fb_posa)])[order]
        last_pos = counts - 1  # no stopwords: every token takes the next position
        return ValueTokens(None, value_idx, pos_pre, last_pos, counts, "device",
                           term_ids=term_ids, vocab=vocab)


def analyze_burst(batched: BatchedAnalyzer, values: list[str], value_doc, n_docs: int,
                  mode: str | None = None, device=None) -> BurstResult:
    """A burst's flat `values` with their doc index (doc-major) -> per-doc
    token streams, positions chained with the +100 multi-value gap as
    `PackBuilder.add_document` chains them, under one `build.analyze`
    stage. `mode` None routes by `use_device_build` on `device` (see the
    module docstring)."""
    from ..index import device_build
    from ..monitoring.refresh_profile import build_stage

    V = len(values)
    nbytes = sum(map(len, values))
    if batched.route != "standard":
        mode = "host"
    elif mode is None:
        mode = ("device" if batched.device_eligible and device_build.use_device_build(
            nbytes, device, device_build.ANALYZE_DEVICE_MIN) else "batched")
    dev = torch.device(device or "cpu") if mode == "device" else None
    basis = ("device" if mode == "device" else
             "host" if batched.route == "standard" else batched.route)
    with build_stage("build.analyze", dev, nbytes=nbytes, values=V, docs=int(n_docs),
                     basis=basis):
        vt = batched.analyze_values(values, mode=mode, device=dev)
        if vt.term_ids is None:
            value_doc = np.asarray(value_doc, np.int64)
            base_v = _position_bases(vt.last_pos, value_doc, np)
            positions = base_v[vt.value_idx] + vt.pos_pre
            doc_idx = value_doc[vt.value_idx]
            lengths = np.bincount(doc_idx, minlength=n_docs).astype(np.int64)
            return BurstResult(vt.terms, doc_idx, positions, lengths, vt.basis)
        vd = torch.as_tensor(np.asarray(value_doc, np.int64)).to(dev)
        base_v = _position_bases(vt.last_pos, vd, torch)
        positions = base_v[vt.value_idx] + vt.pos_pre
        doc_idx = vd[vt.value_idx]
        lengths = torch.bincount(doc_idx, minlength=n_docs).cpu().numpy().astype(np.int64)
        return BurstResult(None, doc_idx, positions, lengths, vt.basis,
                           term_ids=vt.term_ids, vocab=vt.vocab)


def _position_bases(last_pos, value_doc, xp):
    """Each value's first position within its doc: the exclusive cumsum of
    (last position + 1 + the position increment gap) over the doc's earlier
    values."""
    from ..index.pack import POSITION_INCREMENT_GAP

    inc = last_pos + 1 + POSITION_INCREMENT_GAP
    excl = xp.cumsum(inc, 0) - inc
    V = value_doc.shape[0]
    if not V:
        return excl
    first = xp.ones(V, dtype=bool) if xp is np else torch.ones(V, dtype=torch.bool,
                                                               device=value_doc.device)
    first[1:] = value_doc[1:] != value_doc[:-1]
    group = xp.cumsum(first, 0) - 1
    return excl - excl[first][group]
