"""Pure-Python sentencepiece unigram tokenizer (T5/FLAN-T5 vocabulary).

The reference tokenizes with the sentencepiece C++ ``T5Tokenizer``
(NLP_workloads/Anyscale_job/utils.py:23-28; requirements.txt:146).  This
environment has neither the sentencepiece wheel nor network access, so the
framework ships a dependency-free implementation that loads the REAL
FLAN-T5 vocabulary from either on-disk asset format:

* ``spiece.model``   — the sentencepiece ``ModelProto`` (a protobuf; parsed
                       here with a minimal wire-format reader, no protoc),
* ``tokenizer.json`` — the HF fast-tokenizer serialization of the same
                       Unigram model.

Encoding is standard unigram-LM Viterbi segmentation: normalize (NFKC,
whitespace collapse, ``▁`` escaping with a dummy prefix — T5's ``nmt_nfkc``
normalizer approximated), then pick the piece segmentation with the highest
total log-probability.  Unknown characters get the sentencepiece unk penalty
(min piece score − 10).

Parity is tested against the Rust ``tokenizers`` Unigram model when that
library is importable (tests/test_tokenizer_spm.py).
"""

from __future__ import annotations

import json
import os
import re
import struct
import unicodedata
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

SPIECE_UNDERLINE = "▁"  # ▁

# sentencepiece_model.proto piece types
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6

_UNK_PENALTY = 10.0


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format reader (just enough for ModelProto)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message body."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """Parse a sentencepiece ``ModelProto`` → [(piece, score, type), ...].

    ModelProto field 1 = repeated SentencePiece{piece:1 string,
    score:2 float, type:3 enum}.  Everything else (trainer/normalizer
    specs) is skipped — specials are identified by piece type.
    """
    pieces: List[Tuple[str, float, int]] = []
    for field, wt, val in _iter_fields(data):
        if field == 1 and wt == 2:
            piece, score, ptype = "", 0.0, _NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append((piece, score, ptype))
    if not pieces:
        raise ValueError("no pieces found — not a sentencepiece ModelProto?")
    return pieces


def serialize_model_proto(pieces: List[Tuple[str, float, int]]) -> bytes:
    """Inverse of :func:`parse_model_proto` (used by save_pretrained and to
    build test fixtures without the sentencepiece wheel)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = bytearray()
        pb = piece.encode("utf-8")
        body += b"\x0a" + _varint(len(pb)) + pb           # field 1, wt 2
        body += b"\x15" + struct.pack("<f", score)        # field 2, wt 5
        body += b"\x18" + _varint(ptype)                  # field 3, wt 0
        out += b"\x0a" + _varint(len(body)) + bytes(body)  # ModelProto.pieces
    return bytes(out)


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


# ---------------------------------------------------------------------------
# Unigram Viterbi encoder
# ---------------------------------------------------------------------------

class SentencePieceUnigram:
    """Unigram-LM tokenizer over a piece vocabulary with Viterbi decoding."""

    def __init__(
        self,
        pieces: List[Tuple[str, float, int]],
        *,
        add_dummy_prefix: bool = True,
        remove_extra_whitespaces: bool = True,
    ):
        self.pieces = pieces
        self.add_dummy_prefix = add_dummy_prefix
        self.remove_extra_whitespaces = remove_extra_whitespaces
        self.piece_to_id: Dict[str, int] = {}
        self.id_to_piece: List[str] = []
        self.scores: List[float] = []
        self.types: List[int] = []
        self.unk_id = 0
        for i, (piece, score, ptype) in enumerate(pieces):
            # first occurrence wins, like sentencepiece
            self.piece_to_id.setdefault(piece, i)
            self.id_to_piece.append(piece)
            self.scores.append(score)
            self.types.append(ptype)
            if ptype == _UNKNOWN:
                self.unk_id = i
        scorable = [s for s, t in zip(self.scores, self.types) if t == _NORMAL]
        min_score = min(scorable) if scorable else 0.0
        self._unk_score = min_score - _UNK_PENALTY
        self._max_piece_len = max((len(p) for p, _, t in pieces if t != _UNKNOWN), default=1)
        # prefix-keyed lookup: for Viterbi we need all pieces matching at a
        # position; a dict keyed by piece string with a windowed scan is
        # O(len * max_piece_len) per sentence — fine for host-side tokenize
        self._vocab_set = {
            p for p, _, t in pieces if t in (_NORMAL, _USER_DEFINED, _CONTROL, _BYTE)
        }

    # -- normalization (nmt_nfkc approximation) ----------------------------
    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        if self.remove_extra_whitespaces:
            text = " ".join(text.split())
        if not text:
            return ""
        if self.add_dummy_prefix:
            text = " " + text
        return text.replace(" ", SPIECE_UNDERLINE)

    def encode_pieces(self, text: str) -> List[str]:
        s = self.normalize(text)
        if not s:
            return []
        n = len(s)
        # Viterbi over character positions
        best = [-1e18] * (n + 1)
        back: List[Tuple[int, Optional[str]]] = [(-1, None)] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] <= -1e18:
                continue
            # unknown single char fallback
            cand = best[i] + self._unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, None)
            for ln in range(1, min(self._max_piece_len, n - i) + 1):
                sub = s[i:i + ln]
                if sub in self._vocab_set:
                    idx = self.piece_to_id[sub]
                    cand = best[i] + self.scores[idx]
                    if cand > best[i + ln]:
                        best[i + ln] = cand
                        back[i + ln] = (i, sub)
        # trace back
        out: List[str] = []
        pos = n
        while pos > 0:
            prev, piece = back[pos]
            out.append(piece if piece is not None else s[prev:pos])
            pos = prev
        out.reverse()
        # merge adjacent unknowns like sentencepiece's unk aggregation? spm
        # emits one unk per unknown character span element; keep per-char
        return out

    def piece_id(self, piece: str) -> int:
        return self.piece_to_id.get(piece, self.unk_id)

    def encode_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for p in self.encode_pieces(text):
            i = self.piece_to_id.get(p, self.unk_id)
            # sentencepiece fuses runs of unknown characters into ONE <unk>
            if i == self.unk_id and ids and ids[-1] == self.unk_id:
                continue
            ids.append(i)
        return ids

    def decode_pieces(self, pieces: List[str]) -> str:
        text = "".join(pieces).replace(SPIECE_UNDERLINE, " ")
        return text.lstrip(" ") if self.add_dummy_prefix else text


# ---------------------------------------------------------------------------
# T5 tokenizer surface over the unigram core
# ---------------------------------------------------------------------------

class T5SentencePieceTokenizer:
    """HF-``T5Tokenizer``-compatible surface over :class:`SentencePieceUnigram`.

    Load from a directory (or file) holding ``spiece.model`` or
    ``tokenizer.json``.  T5 convention: pad=0, eos=1 (``</s>``), unk=2,
    plus ``extra_ids`` sentinel tokens appended at the END of the id space
    in REVERSE order (``<extra_id_0>`` = vocab_size-1), exactly like HF.
    """

    def __init__(
        self,
        sp: SentencePieceUnigram,
        model_max_length: int = 512,
        extra_ids: int = 100,
    ):
        self.sp = sp
        self.model_max_length = model_max_length
        self.extra_ids = extra_ids
        self._base = len(sp.id_to_piece)
        self.vocab_size = self._base + extra_ids
        self.pad_token = "<pad>"
        self.eos_token = "</s>"
        self.unk_token = "<unk>"
        self.pad_token_id = sp.piece_to_id.get("<pad>", 0)
        self.eos_token_id = sp.piece_to_id.get("</s>", 1)
        self.unk_token_id = sp.unk_id
        # <extra_id_0> is the LAST id, <extra_id_99> the first extra slot
        self._extra_to_id = {
            f"<extra_id_{i}>": self.vocab_size - 1 - i for i in range(extra_ids)
        }
        self._id_to_extra = {v: k for k, v in self._extra_to_id.items()}

    # -- loading -----------------------------------------------------------
    @classmethod
    def from_pretrained(
        cls, path: str, model_max_length: int = 512, extra_ids: int = 100
    ) -> "T5SentencePieceTokenizer":
        spm_path, json_path = None, None
        if os.path.isdir(path):
            for name in ("spiece.model", "sentencepiece.model"):
                p = os.path.join(path, name)
                if os.path.exists(p):
                    spm_path = p
                    break
            p = os.path.join(path, "tokenizer.json")
            if os.path.exists(p):
                json_path = p
            cfg_path = os.path.join(path, "tokenizer_config.json")
            if os.path.exists(cfg_path):
                try:
                    with open(cfg_path) as f:
                        cfg = json.load(f)
                    model_max_length = cfg.get("model_max_length", model_max_length)
                    # honor the saved sentinel count — otherwise a
                    # save/load round-trip would shift every <extra_id_*>
                    extra_ids = cfg.get("extra_ids", extra_ids)
                except Exception:  # noqa: BLE001 — malformed sidecar config: keep defaults
                    pass
        elif path.endswith(".model"):
            spm_path = path
        elif path.endswith(".json"):
            json_path = path
        if spm_path:
            with open(spm_path, "rb") as f:
                pieces = parse_model_proto(f.read())
            return cls(SentencePieceUnigram(pieces), model_max_length, extra_ids)
        if json_path:
            return cls.from_tokenizer_json(json_path, model_max_length)
        raise FileNotFoundError(
            f"no spiece.model or tokenizer.json under {path!r}"
        )

    @classmethod
    def from_tokenizer_json(
        cls, path: str, model_max_length: int = 512
    ) -> "T5SentencePieceTokenizer":
        with open(path) as f:
            tj = json.load(f)
        model = tj.get("model", {})
        if model.get("type") != "Unigram":
            raise ValueError(f"tokenizer.json model type {model.get('type')!r} != Unigram")
        vocab = model["vocab"]  # [[piece, score], ...]
        unk_id = model.get("unk_id", 2)
        pieces: List[Tuple[str, float, int]] = []
        n_extra = 0
        for i, (piece, score) in enumerate(vocab):
            if i == unk_id:
                ptype = _UNKNOWN
            elif piece in ("<pad>", "</s>", "<s>"):
                ptype = _CONTROL
            elif piece.startswith("<extra_id_") and piece.endswith(">"):
                ptype = _USER_DEFINED
                n_extra += 1
            else:
                ptype = _NORMAL
            pieces.append((piece, score, ptype))
        if n_extra:
            # HF fast files already include the sentinels in-vocab; keep
            # their ids and disable the synthetic extra-id block
            pieces_main = pieces
            tok = cls(SentencePieceUnigram(pieces_main), model_max_length, extra_ids=0)
            tok._extra_to_id = {
                p: i for i, (p, _, t) in enumerate(pieces) if t == _USER_DEFINED
            }
            tok._id_to_extra = {v: k for k, v in tok._extra_to_id.items()}
            return tok
        return cls(SentencePieceUnigram(pieces), model_max_length)

    # -- encode ------------------------------------------------------------
    _SENTINEL_RE = re.compile(r"(<extra_id_\d+>)")

    def encode(self, text: str, add_eos: bool = True) -> List[int]:
        ids: List[int] = []
        # split out sentinel tokens verbatim (T5 infilling convention);
        # one regex pass — no per-sentinel substring scans
        for part in self._SENTINEL_RE.split(text):
            if not part:
                continue
            sid = self._extra_to_id.get(part)
            if sid is not None:
                ids.append(sid)
            else:
                ids.extend(self.sp.encode_ids(part))
        if add_eos:
            ids.append(self.eos_token_id)
        return ids

    def __call__(
        self,
        text: Union[str, List[str]],
        max_length: Optional[int] = None,
        padding: Union[bool, str] = False,
        truncation: bool = False,
        return_tensors: Optional[str] = None,
        add_special_tokens: bool = True,
    ) -> Dict[str, Union[List, np.ndarray]]:
        texts = [text] if isinstance(text, str) else list(text)
        seqs = [self.encode(t, add_eos=add_special_tokens) for t in texts]
        limit = max_length or self.model_max_length
        if truncation:
            seqs = [s[:limit] for s in seqs]
        if padding == "max_length":
            width = limit
        elif padding in (True, "longest"):
            width = max((len(s) for s in seqs), default=0)
        else:
            width = None
        if width is not None:
            attn = [[1] * len(s) + [0] * max(0, width - len(s)) for s in seqs]
            seqs = [s + [self.pad_token_id] * max(0, width - len(s)) for s in seqs]
        else:
            attn = [[1] * len(s) for s in seqs]
        out = {"input_ids": seqs, "attention_mask": attn}
        if return_tensors in ("np", "jax"):
            if len({len(s) for s in seqs}) > 1:
                raise ValueError(
                    "ragged sequences cannot become tensors — pass "
                    "truncation=True (some inputs exceed max_length)"
                )
            out = {k: np.asarray(v, dtype=np.int32) for k, v in out.items()}
        return out

    # -- decode ------------------------------------------------------------
    def convert_ids_to_tokens(self, ids) -> List[str]:
        toks = []
        for i in ids:
            i = int(i)
            if i in self._id_to_extra:
                toks.append(self._id_to_extra[i])
            elif 0 <= i < self._base:
                toks.append(self.sp.id_to_piece[i])
            else:
                toks.append(self.unk_token)
        return toks

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        pieces = []
        # one host pull for the whole sequence: a device array decodes with
        # a single transfer instead of one sync per token (airlint JX004)
        for i in np.asarray(ids, dtype=np.int64).tolist():
            if skip_special_tokens and (
                i in (self.pad_token_id, self.eos_token_id)
                or (i < self._base and self.sp.types[i] == _CONTROL)
            ):
                continue
            if i in self._id_to_extra:
                pieces.append(self._id_to_extra[i])
            elif 0 <= i < self._base:
                pieces.append(self.sp.id_to_piece[i])
        return self.sp.decode_pieces(pieces)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(row, skip_special_tokens) for row in np.asarray(batch)]

    # -- persistence --------------------------------------------------------
    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "spiece.model"), "wb") as f:
            f.write(serialize_model_proto(self.sp.pieces))
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump(
                {
                    "tokenizer_class": "T5SentencePieceTokenizer",
                    "model_max_length": self.model_max_length,
                    "extra_ids": self.extra_ids,
                },
                f,
            )


# ---------------------------------------------------------------------------
# unigram training (EM) — produce REAL .model assets without the spm wheel
# ---------------------------------------------------------------------------

def train_unigram(
    texts: List[str],
    vocab_size: int = 2048,
    max_piece_len: int = 8,
    seed_factor: int = 8,
    em_iters: int = 2,
    shrink_factor: float = 0.75,
) -> List[Tuple[str, float, int]]:
    """Train a unigram-LM piece vocabulary (the sentencepiece algorithm,
    simplified): seed with frequent substrings of ▁-escaped words, run EM
    (forward-backward expected counts over each word's segmentation
    lattice), and iteratively prune low-count pieces until ``vocab_size``
    NORMAL pieces remain — single characters are never pruned (full
    character coverage, like spm's required_chars).  Returns
    ``(piece, log-prob score, type)`` rows ready for
    :func:`serialize_model_proto`.
    """
    import math
    from collections import Counter

    # ▁-escaped word counts (the training view of the corpus)
    words: Counter = Counter()
    for text in texts:
        text = unicodedata.normalize("NFKC", text)
        for w in text.split():
            words[SPIECE_UNDERLINE + w] += 1

    chars: Counter = Counter()
    for w, f in words.items():
        for ch in w:
            chars[ch] += f
    required = set(chars)

    # seed: frequent substrings, scored by count * len (spm's seed heuristic)
    subs: Counter = Counter()
    for w, f in words.items():
        L = len(w)
        for i in range(L):
            for ln in range(2, min(max_piece_len, L - i) + 1):
                subs[w[i : i + ln]] += f
    seed_n = max(seed_factor * vocab_size, vocab_size + len(required))
    seeded = [
        s for s, c in sorted(
            subs.items(), key=lambda kv: (-kv[1] * len(kv[0]), kv[0])
        )[:seed_n]
    ]
    vocab = {p: float(subs[p] * len(p)) for p in seeded}
    for ch in required:
        vocab[ch] = float(max(chars[ch], 1))

    def em_round(vocab):
        total = sum(vocab.values())
        logp = {p: math.log(c / total) for p, c in vocab.items()}
        maxlen = max(len(p) for p in logp)
        counts: Counter = Counter()
        for w, f in words.items():
            n = len(w)
            # forward
            alpha = [-1e30] * (n + 1)
            alpha[0] = 0.0
            arcs = [[] for _ in range(n + 1)]  # arcs[end] = [(start, piece, lp)]
            for i in range(n):
                if alpha[i] <= -1e29:
                    continue
                for ln in range(1, min(maxlen, n - i) + 1):
                    sub = w[i : i + ln]
                    lp = logp.get(sub)
                    if lp is None:
                        continue
                    arcs[i + ln].append((i, sub, lp))
                    cand = alpha[i] + lp
                    a = alpha[i + ln]
                    m = cand if cand > a else a
                    alpha[i + ln] = m + math.log1p(math.exp(-abs(cand - a))) \
                        if a > -1e29 else cand
            if alpha[n] <= -1e29:
                continue  # unreachable (cannot happen: chars are in vocab)
            # backward
            beta = [-1e30] * (n + 1)
            beta[n] = 0.0
            for end in range(n, 0, -1):
                if beta[end] <= -1e29:
                    continue
                for i, sub, lp in arcs[end]:
                    cand = beta[end] + lp
                    b = beta[i]
                    m = cand if cand > b else b
                    beta[i] = m + math.log1p(math.exp(-abs(cand - b))) \
                        if b > -1e29 else cand
            z = alpha[n]
            for end in range(1, n + 1):
                for i, sub, lp in arcs[end]:
                    post = alpha[i] + lp + beta[end] - z
                    if post > -30.0:
                        counts[sub] += f * math.exp(post)
        return counts

    while True:
        for _ in range(em_iters):
            counts = em_round(vocab)
            vocab = {
                p: max(counts.get(p, 0.0), 1e-6 if p in required else 0.0)
                for p in vocab
            }
            vocab = {p: c for p, c in vocab.items() if c > 0.0}
        n_prunable = len(vocab)
        if n_prunable <= vocab_size:
            break
        keep = max(vocab_size, int(n_prunable * shrink_factor))
        ranked = sorted(vocab.items(), key=lambda kv: (-kv[1], kv[0]))
        kept = {p: c for p, c in ranked[:keep]}
        for ch in required:  # coverage is non-negotiable
            kept.setdefault(ch, vocab.get(ch, 1e-6))
        if len(kept) == len(vocab):
            break  # nothing prunable left beyond required chars
        vocab = kept

    total = sum(vocab.values())
    import math as _m

    scored = sorted(
        ((p, _m.log(c / total)) for p, c in vocab.items()),
        key=lambda kv: (-kv[1], kv[0]),
    )
    return [(p, s, _NORMAL) for p, s in scored]


def train_t5_tokenizer(
    texts: List[str], vocab_size: int = 2048, model_max_length: int = 512,
    extra_ids: int = 100, **train_kwargs,
) -> "T5SentencePieceTokenizer":
    """Train and wrap with the T5 id layout (pad=0, eos=1, unk=2)."""
    normal = train_unigram(texts, vocab_size=vocab_size, **train_kwargs)
    pieces = [
        ("<pad>", 0.0, _CONTROL),
        ("</s>", 0.0, _CONTROL),
        ("<unk>", 0.0, _UNKNOWN),
    ] + normal
    return T5SentencePieceTokenizer(
        SentencePieceUnigram(pieces), model_max_length=model_max_length,
        extra_ids=extra_ids,
    )
