"""Synthetic Europarl-shaped corpus, made from a seed (a copy of the JAX
package's ``bench.make_corpus``, so the port needs nothing of it).

Europarl-v7 English, the reference workload, has 1,965,734 lines and
49,158,635 running words; this generator draws Zipf-ranked words of
variable length from an 80,000-word vocabulary, ~12% of it carrying
attached punctuation, with newlines at the reference's line cadence and
a tail of >128-byte words that exercise the host materialisation's
long-word path.  No download: the same seed gives the same bytes.
"""

from __future__ import annotations

import numpy as np

N_WORDS = 49_158_635         # Europarl-v7 English running words
N_LINES = 1_965_734
VOCAB = 80_000
N_PUNCT_VOCAB = 10_000       # vocab entries that are word+punctuation
N_LONG = 5                   # distinct >128-byte tokens (tail words)
LONG_REPEATS = 8             # occurrences of each tail word


def make_corpus(n_words: int = N_WORDS, n_lines: int = N_LINES,
                vocab_size: int = VOCAB, seed: int = 0) -> bytes:
    """Europarl-shaped text at Europarl scale, built with vectorised numpy
    (no Python loop over 49M tokens): variable Zipf-ranked token lengths
    (natural ~5-char mean instead of fixed-width cells), ~12% of the
    vocabulary carrying attached punctuation ("word," and "word" co-occur
    as distinct whitespace tokens, as in the real corpus), and a tail of
    >128-byte tokens so the materialise window-overflow fallback
    (engine/wordcount.gather_words) runs at full scale."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    MAXW = 16

    # vocabulary: variable lengths ~Binomial(12,.35)+1 (mean ~5.2 chars)
    n_base = vocab_size - N_PUNCT_VOCAB
    lengths = (1 + rng.binomial(12, 0.35, size=vocab_size)).astype(np.int32)
    np.minimum(lengths, MAXW - 1, out=lengths)
    vocab = np.zeros((vocab_size, MAXW), dtype=np.uint8)
    mask = np.arange(MAXW)[None, :] < lengths[:, None]
    vocab[mask] = letters[rng.integers(0, 26, size=int(mask.sum()))]
    # punctuation-attached variants: copies of base words + one of .,;:!?
    punct = np.frombuffer(b".,;:!?", dtype=np.uint8)
    base_of = rng.integers(0, n_base, size=N_PUNCT_VOCAB)
    vocab[n_base:] = vocab[base_of]
    lengths[n_base:] = lengths[base_of]
    vocab[np.arange(n_base, vocab_size),
          lengths[n_base:]] = punct[rng.integers(0, 6, N_PUNCT_VOCAB)]
    lengths[n_base:] += 1

    # Zipf-ranked draw (punct variants ride their base word's rank zone)
    p = 1.0 / (np.arange(vocab_size) + 10.0)
    p /= p.sum()
    n_tail = N_LONG * LONG_REPEATS if n_words > 2 * N_LONG * LONG_REPEATS \
        else 0
    ids = rng.choice(vocab_size, size=n_words - n_tail, p=p)

    # variable-width assembly: scatter word bytes at cumsum offsets,
    # chunked so the [C, W] index temporaries stay ~100MB
    widths = (lengths[ids] + 1).astype(np.int64)  # +1 separator byte
    offsets = np.concatenate([np.zeros(1, np.int64), np.cumsum(widths)])
    out = np.empty(int(offsets[-1]), dtype=np.uint8)
    CH = 1 << 22
    for lo in range(0, ids.size, CH):
        idc = ids[lo:lo + CH]
        L = lengths[idc]
        W = int(L.max())
        span = np.arange(W)
        m = span[None, :] < L[:, None]
        flat = (offsets[lo:lo + idc.size, None] + span[None, :])[m]
        out[flat] = vocab[idc][:, :W][m]
    sep_pos = offsets[1:] - 1
    out[sep_pos] = ord(" ")
    # newline terminators at the line cadence of the reference corpus
    line_every = max(n_words // n_lines, 1)
    out[sep_pos[line_every - 1::line_every]] = ord("\n")

    if not n_tail:
        return out.tobytes()
    # >128-byte tail words (window is 128; these must take the fallback)
    tail_words = []
    for i in range(N_LONG):
        ln = int(rng.integers(140, 200))
        tail_words.append(bytes(letters[rng.integers(0, 26, ln)]))
    tail = bytearray()
    for r in range(LONG_REPEATS):
        for w in tail_words:
            tail += w + (b"\n" if r % 3 == 2 else b" ")
    return out.tobytes() + bytes(tail)
