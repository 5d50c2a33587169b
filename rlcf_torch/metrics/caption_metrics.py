"""Caption reference metrics: BLEU-1..4, ROUGE-L, CIDEr-D, METEOR (the
port's own copy of ``rlcf_tpu/metrics/caption_metrics.py``).

Pure-Python implementations of the pycocoevalcap scorers the reference wraps
(`clipscore/generation_eval_utils.py:17-40`): corpus BLEU with clipped counts
and closest-reference brevity penalty, coco-caption ROUGE-L (beta=1.2, max
precision/recall over references), and CIDEr-D (n<=4 TF-IDF with sigma=6
length gaussian and count clipping, x10).

Tokenization: pycocoevalcap shells out to the Java Stanford PTBTokenizer
(`-preserveLines -lowerCase`) and drops a fixed punctuation-token set
(`pycocoevalcap/tokenizer/ptbtokenizer.py`). ``ptb_tokenize`` reproduces
that pipeline with nltk's TreebankWordTokenizer (a pure-regex port of the
Penn Treebank rules: contraction/possessive splitting, ``-LRB-`` bracket
normalization, quote conversion) + the same punctuation-removal set —
identical tokens on ordinary caption text; exotic unicode/URL inputs may
still split differently. METEOR (a Java jar upstream) uses nltk's aligner:
exact/stem/synonym stages with wordnet data, exact+stem without. The port
never downloads the corpus (``ensure_wordnet`` only probes it, and
``clipscore_eval --download_nltk 1`` is refused); the active variant is
reported via ``meteor_mode()`` / the ``meteor_mode`` result field and a
RuntimeWarning fires once when degraded.
"""

from __future__ import annotations

import collections
import math
import re
from typing import Dict, List, Sequence

_PUNCT = re.compile(r"[^\w\s]")

# the exact token set pycocoevalcap removes AFTER Stanford tokenization
# (`pycocoevalcap/tokenizer/ptbtokenizer.py:PUNCTUATIONS`)
_PTB_REMOVE = frozenset([
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
])
_TREEBANK = None


def ptb_tokenize(text: str) -> List[str]:
    """pycocoevalcap-equivalent tokenization: PTB rules, lowercase, then drop
    the fixed punctuation-token set. Possessives survive as ``'s`` and
    contractions split (``doesn't`` -> ``does n't``) exactly like the
    reference's Java tokenizer; hyphenated words stay joined."""
    global _TREEBANK
    if _TREEBANK is None:
        try:
            from nltk.tokenize import TreebankWordTokenizer

            _TREEBANK = TreebankWordTokenizer()
        except Exception:
            _TREEBANK = False
    if _TREEBANK:
        toks = _TREEBANK.tokenize(text.lower().strip(), convert_parentheses=True)
    else:  # no nltk: legacy lowercase/strip-punctuation approximation
        t = _PUNCT.sub("", text.lower().strip().replace("-", " "))
        toks = t.split()
    return [t for t in toks if t not in _PTB_REMOVE]


def _ngrams(tokens: Sequence[str], n: int):
    return collections.Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU (corpus, clipped counts, closest-ref brevity penalty)
# ---------------------------------------------------------------------------


def bleu(references: List[List[str]], candidates: List[str], max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n. references[i] = list of refs for candidates[i]."""
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = 0
    ref_len = 0
    for refs, cand in zip(references, candidates):
        cand_toks = ptb_tokenize(cand)
        ref_toks = [ptb_tokenize(r) for r in refs]
        cand_len += len(cand_toks)
        # closest reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(cand_toks)), len(r)) for r in ref_toks)[1]
        for n in range(1, max_n + 1):
            c_counts = _ngrams(cand_toks, n)
            max_ref = collections.Counter()
            for r in ref_toks:
                for ng, cnt in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], cnt)
            clipped[n - 1] += sum(min(cnt, max_ref[ng]) for ng, cnt in c_counts.items())
            totals[n - 1] += max(sum(c_counts.values()), 0)
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    out = []
    log_sum = 0.0
    for n in range(max_n):
        p = clipped[n] / totals[n] if totals[n] > 0 else 0.0
        # pycocoevalcap uses a tiny epsilon rather than zeroing the geo-mean
        log_sum += math.log(max(p, 1e-12))
        out.append(bp * math.exp(log_sum / (n + 1)))
    return out


# ---------------------------------------------------------------------------
# ROUGE-L (coco-caption: beta=1.2, max over references)
# ---------------------------------------------------------------------------


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(references: List[List[str]], candidates: List[str], beta: float = 1.2) -> float:
    scores = []
    for refs, cand in zip(references, candidates):
        c = ptb_tokenize(cand)
        prec, rec = [], []
        for r in refs:
            rt = ptb_tokenize(r)
            lcs = _lcs_len(c, rt)
            prec.append(lcs / max(len(c), 1))
            rec.append(lcs / max(len(rt), 1))
        p, r = max(prec), max(rec)
        scores.append(((1 + beta**2) * p * r) / (r + beta**2 * p) if p and r else 0.0)
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# CIDEr-D (sigma=6, n<=4, clipped candidate counts, x10)
# ---------------------------------------------------------------------------


def cider_d(references: List[List[str]], candidates: List[str], n_max: int = 4, sigma: float = 6.0) -> float:
    cand_toks = [ptb_tokenize(c) for c in candidates]
    ref_toks = [[ptb_tokenize(r) for r in refs] for refs in references]

    # document frequency over reference sets
    df = [collections.Counter() for _ in range(n_max)]
    for refs in ref_toks:
        seen = [set() for _ in range(n_max)]
        for r in refs:
            for n in range(n_max):
                seen[n].update(_ngrams(r, n + 1).keys())
        for n in range(n_max):
            for ng in seen[n]:
                df[n][ng] += 1
    n_docs = max(len(ref_toks), 1)
    log_docs = math.log(max(n_docs, 1))

    def tfidf_vec(tokens, n):
        counts = _ngrams(tokens, n + 1)
        vec = {}
        norm_sq = 0.0
        for ng, cnt in counts.items():
            idf = log_docs - math.log(max(df[n][ng], 1.0))
            w = cnt * idf
            vec[ng] = w
            norm_sq += w * w
        return vec, math.sqrt(norm_sq), counts

    scores = []
    for c_toks, refs in zip(cand_toks, ref_toks):
        score_n = [0.0] * n_max
        for n in range(n_max):
            c_vec, c_norm, c_counts = tfidf_vec(c_toks, n)
            for r in refs:
                r_vec, r_norm, _ = tfidf_vec(r, n)
                # clipped dot product (CIDEr-D: min of candidate count weight)
                dot = 0.0
                for ng, w in c_vec.items():
                    if ng in r_vec:
                        dot += min(w, r_vec[ng]) * r_vec[ng]
                delta = len(c_toks) - len(r)
                gauss = math.exp(-(delta**2) / (2 * sigma**2))
                if c_norm > 0 and r_norm > 0:
                    score_n[n] += gauss * dot / (c_norm * r_norm)
            score_n[n] /= max(len(refs), 1)
        scores.append(10.0 * sum(score_n) / n_max)
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# METEOR (nltk-backed; exact+stem stages when wordnet data is unavailable)
# ---------------------------------------------------------------------------


class _NoWordnet:
    """Stub wordnet reader: disables the synonym stage of nltk's METEOR
    aligner (the exact and Porter-stem stages still run). Used when the
    wordnet corpus data is not installed."""

    @staticmethod
    def synsets(word):
        return []


_METEOR_MODE: str | None = None
_METEOR_WARNED = False


def _probe_meteor_mode() -> str:
    try:
        from nltk.corpus import wordnet as wn

        wn.synsets("dog")  # raises LookupError when corpus data missing
        return "nltk_wordnet"
    except Exception:
        try:
            import nltk.translate.meteor_score  # noqa: F401

            return "exact+stem"
        except Exception:
            return "exact_approx"


def meteor_mode() -> str:
    """Which METEOR variant this environment can compute.

    - "nltk_wordnet": nltk aligner with exact/stem/synonym stages (wordnet
      data installed). Closest available to pycocoevalcap's METEOR 1.5 —
      still not identical (no paraphrase tables, different parameters).
    - "exact+stem": nltk aligner with the synonym stage disabled.
    - "exact_approx": hand-rolled exact matcher (nltk missing entirely).
    """
    global _METEOR_MODE
    if _METEOR_MODE is None:
        _METEOR_MODE = _probe_meteor_mode()
    return _METEOR_MODE


def ensure_wordnet() -> str:
    """Probe the wordnet corpus again and return the resulting
    :func:`meteor_mode`. Unlike the JAX package's, it never downloads the
    corpus: the port needs no network, and a machine that has the corpus
    installed gets the synonym stage from it."""
    global _METEOR_MODE
    _METEOR_MODE = _probe_meteor_mode()
    return _METEOR_MODE


def meteor(references: List[List[str]], candidates: List[str]) -> float:
    """Mean METEOR over candidates; the matching stages depend on available
    data — see ``meteor_mode()``. Degraded modes warn loudly ONCE per process
    (the reference scores with pycocoevalcap's METEOR 1.5 jar,
    `clipscore/generation_eval_utils.py:17-40`; a silently different scorer
    would skew comparisons)."""
    global _METEOR_WARNED
    mode = meteor_mode()
    if mode != "nltk_wordnet" and not _METEOR_WARNED:
        import warnings

        warnings.warn(
            f"METEOR degraded to '{mode}': wordnet corpus data is not installed, "
            "so synonym matching is disabled. Scores are NOT comparable to "
            "pycocoevalcap's METEOR 1.5 (reference scorer). Results carry a "
            "'meteor_mode' field recording this.",
            RuntimeWarning,
            stacklevel=2,
        )
        _METEOR_WARNED = True
    if mode == "exact_approx":
        return _meteor_exact(references, candidates)
    from nltk.translate.meteor_score import meteor_score

    kwargs = {} if mode == "nltk_wordnet" else {"wordnet": _NoWordnet()}
    scores = [
        meteor_score([ptb_tokenize(r) for r in refs], ptb_tokenize(c), **kwargs)
        for refs, c in zip(references, candidates)
    ]
    return sum(scores) / max(len(scores), 1)


def _meteor_exact(references: List[List[str]], candidates: List[str], alpha=0.9, beta=3.0, gamma=0.5) -> float:
    """Exact-match METEOR (no stem/synonym stages; wordnet unavailable)."""
    scores = []
    for refs, cand in zip(references, candidates):
        c = ptb_tokenize(cand)
        best = 0.0
        for ref in refs:
            r = ptb_tokenize(ref)
            matches = []
            used = set()
            for i, tok in enumerate(c):
                for j, rt in enumerate(r):
                    if j not in used and tok == rt:
                        matches.append((i, j))
                        used.add(j)
                        break
            m = len(matches)
            if m == 0:
                continue
            p = m / len(c)
            rr = m / len(r)
            f = p * rr / (alpha * p + (1 - alpha) * rr)
            chunks = 1
            for (i1, j1), (i2, j2) in zip(matches, matches[1:]):
                if not (i2 == i1 + 1 and j2 == j1 + 1):
                    chunks += 1
            penalty = gamma * (chunks / m) ** beta
            best = max(best, f * (1 - penalty))
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


def pycocoevalcap_available() -> bool:
    try:
        import pycocoevalcap  # noqa: F401

        return True
    except ImportError:
        return False


def get_all_metrics_pycoco(references: List[List[str]], candidates: List[str]) -> Dict:
    """Score through real pycocoevalcap + the Java PTBTokenizer — the
    reference's exact scorer stack (`clipscore/generation_eval_utils.py:17-60`).
    Raises ImportError when the package is absent; callers use :func:`get_all_metrics` which falls back."""
    from pycocoevalcap.bleu.bleu import Bleu
    from pycocoevalcap.cider.cider import Cider
    from pycocoevalcap.meteor.meteor import Meteor
    from pycocoevalcap.rouge.rouge import Rouge
    from pycocoevalcap.tokenizer.ptbtokenizer import PTBTokenizer

    tokenizer = PTBTokenizer()
    refs = {i: [{"caption": r} for r in rs] for i, rs in enumerate(references)}
    cands = {i: [{"caption": c}] for i, c in enumerate(candidates)}
    refs = tokenizer.tokenize(refs)
    cands = tokenizer.tokenize(cands)
    out: Dict = {"caption_metrics_backend": "pycocoevalcap"}
    bleu_scores, _ = Bleu(4).compute_score(refs, cands)
    out["bleu"] = list(bleu_scores)
    out["meteor"], _ = Meteor().compute_score(refs, cands)
    out["meteor_mode"] = "pycocoevalcap_jar"
    out["rouge"], _ = Rouge().compute_score(refs, cands)
    out["cider"], _ = Cider().compute_score(refs, cands)
    return out


def get_all_metrics(references: List[List[str]], candidates: List[str]) -> Dict:
    """Full suite matching `generation_eval_utils.get_all_metrics` keys.

    Delegates to real pycocoevalcap (+ Java PTBTokenizer) when importable —
    score-exact with the reference — and otherwise to the pure-Python
    scorers above. The ``caption_metrics_backend`` field records which ran;
    ``meteor_mode`` records the METEOR variant.
    """
    if pycocoevalcap_available():
        try:
            return get_all_metrics_pycoco(references, candidates)
        except Exception as e:  # jar missing / java absent: fall through
            import warnings

            warnings.warn(
                f"pycocoevalcap present but failed ({e}); using pure-Python scorers",
                RuntimeWarning,
            )
    return {
        "bleu": bleu(references, candidates),
        "meteor": meteor(references, candidates),
        "meteor_mode": meteor_mode(),
        "rouge": rouge_l(references, candidates),
        "cider": cider_d(references, candidates),
        "caption_metrics_backend": "pure-python",
    }
