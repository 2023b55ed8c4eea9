"""The port's CLIP text encoder (``text.text_encoder``) against JAX's
``semivl_tpu/text/text_encoder.py`` on the CPU: the causal transformer on
random weights and token ids (float32, the weights carried by
``convert.clip_text_state_dict``), its causality, and the port's
tokenizer, which uses the standard ``re`` where JAX's uses ``regex``,
against JAX's on a merges file the test learns from the assets' words
(the BPE vocabulary is not in the repository).

Tolerance: 1e-5 of the output's scale (float32 sums in other orders
through two blocks)."""

import collections
import functools
import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semivl_tpu.text import text_encoder as jax_te
from semivl_tpu_torch import convert
from semivl_tpu_torch.datasets.classes import CLASSES
from semivl_tpu_torch.text import text_encoder as te
from semivl_tpu_torch.text.concepts import CONCEPT_LISTS

from torch_parity import init_params, rel_err
from torch_parity import few_threads  # noqa: F401 (autouse)

SMALL = dict(vocab_size=100, context_length=16, width=32, layers=2, heads=4,
             embed_dim=24)


def _tokens(seed=0):
    """Token rows as the tokenizer makes them: ids below the EOT id, the
    EOT id (the row's highest) and zeros after it."""
    rs = np.random.RandomState(seed)
    tokens = np.zeros((3, 16), np.int32)
    for i, n in enumerate((3, 9, 16)):
        tokens[i, :n - 1] = rs.randint(1, 98, n - 1)
        tokens[i, n - 1] = 99
    return tokens


def _pair(seed=0):
    jm = jax_te.CLIPTextTransformer(**SMALL)
    params = init_params(jm, seed, jnp.zeros((1, 16), jnp.int32))
    pm = te.CLIPTextTransformer(**SMALL)
    pm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                        convert.clip_text_state_dict(params).items()},
                       strict=True)
    return jm, params, pm


def test_text_transformer_matches_jax():
    jm, params, pm = _pair()
    tokens = _tokens()
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = pm(torch.from_numpy(tokens).long())
    assert got.shape == want.shape == (3, 24)
    assert rel_err(got.numpy(), want) < 1e-5


def test_text_transformer_is_causal():
    """The pooled feature reads no token after the EOT: changing the
    tokens after it changes nothing."""
    _, _, pm = _pair()
    t1 = _tokens()
    t2 = t1.copy()
    t2[0, 5:] = 7   # after row 0's EOT (position 2)
    with torch.no_grad():
        a, b = (pm(torch.from_numpy(t).long()) for t in (t1, t2))
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1:], b[1:])


def _asset_texts():
    """Every class name and concept string the port carries, and prompts
    made from them."""
    texts = [c for names in CLASSES.values() for c in names]
    for concepts in CONCEPT_LISTS.values():
        texts += [c for cls in concepts for c in cls]
    return texts + [f'a photo of a {t}.' for t in texts[:50]]


def _learn_merges(texts, n_merges=300):
    """A small BPE merges list learned from ``texts`` (CLIP's file format:
    a header line, then one merge a line)."""
    b2u = te.bytes_to_unicode()
    pat = te.split_pattern()
    words = collections.Counter()
    for t in texts:
        for w in pat.findall(t.lower()):
            chars = [b2u[b] for b in w.encode('utf-8')]
            words[tuple(chars[:-1] + [chars[-1] + '</w>'])] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, n in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += n
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    return '#version: 0.2\n' + '\n'.join(' '.join(m) for m in merges)


@pytest.fixture(scope='module')
def tokenizers(tmp_path_factory):
    texts = _asset_texts()
    path = tmp_path_factory.mktemp('bpe') / 'bpe.txt.gz'
    with gzip.open(path, 'wb') as f:
        f.write(_learn_merges(texts).encode('utf-8'))
    return te.SimpleTokenizer(str(path)), jax_te.SimpleTokenizer(str(path))


def test_tokenizer_encodes_the_assets_as_jax(tokenizers):
    """The stdlib tokenizer splits and encodes every class name and
    concept string of the port's assets (and prompts of them) exactly as
    JAX's ``regex`` one does, on the same merges file."""
    port, jax_tok = tokenizers
    texts = _asset_texts()
    assert len(texts) > 400
    merged = 0
    for t in texts:
        got, want = port.encode(t), jax_tok.encode(t)
        assert got == want, t
        merged += len(got) < len(t.replace(' ', ''))
    assert merged > len(texts) // 2   # the merges act on most texts
    np.testing.assert_array_equal(port.tokenize(texts[:40]),
                                  jax_tok.tokenize(texts[:40]))


def test_tokenizer_splits_unicode_as_regex(tokenizers):
    """Letters, numbers and other characters outside ASCII fall into the
    same pre-tokens as under ``regex``'s ``\\p{L}`` / ``\\p{N}``."""
    import regex
    port, jax_tok = tokenizers
    for text in ("café naïve 2½ x² Ⅳ 日本語 ١٢٣ ǅ ＡＢＣ it's",
                 "tv/monitor, potted-plant (sky)! <|endoftext|>"):
        cleaned = port.split(text)
        assert cleaned == regex.findall(jax_tok.pat, ' '.join(
            text.lower().split())), text
    with pytest.raises(FileNotFoundError):
        te.SimpleTokenizer('/nonexistent/bpe.txt.gz')


def test_generate_text_embeddings(tokenizers, monkeypatch):
    """Prompts through the tokenizer and the transformer (its default
    shape made small here) give L2-normalised rows equal to JAX's
    ``generate_text_embeddings`` on the same weights."""
    port_tok, jax_tok = tokenizers
    small = dict(SMALL, vocab_size=len(port_tok.encoder), context_length=77)
    names = CLASSES['pascal'][:5]
    params = init_params(jax_te.CLIPTextTransformer(**small), 3,
                         jnp.zeros((1, 77), jnp.int32))
    monkeypatch.setattr(jax_te, 'CLIPTextTransformer', functools.partial(
        jax_te.CLIPTextTransformer, **small))
    monkeypatch.setattr(te, 'CLIPTextTransformer', functools.partial(
        te.CLIPTextTransformer, **small))
    want = jax_te.generate_text_embeddings(names, params, jax_tok)
    got = te.generate_text_embeddings(
        names, convert.clip_text_state_dict(params), port_tok,
        device='cpu')
    assert got.shape == want.shape == (5, 24)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    assert rel_err(got, want) < 1e-5
