"""CLIP's text encoder and BPE tokenizer, and the embedding generation
(counterpart of ``semivl_tpu/text/text_encoder.py``).

The reference makes its text-embedding ``.npy`` assets offline with OpenAI
CLIP's text tower (model/text_embeddings.py:156-186,
third_party/zegclip/models/backbones/text_encoder.py): a causal text
transformer (width 512, 12 layers, 8 heads, QuickGELU, LayerNorm eps
1e-5), token and position embeddings, ``ln_final``, the text projection,
pooling at the EOT token and an L2 norm. Training reads the precomputed
assets; this module makes or extends them where a CLIP checkpoint and the
BPE vocabulary are at hand (neither is in the repository).

The parameters carry OpenAI CLIP's state-dict names
(``token_embedding.weight``, ``transformer.resblocks.<i>.attn.in_proj_weight``,
``mlp.c_fc``, ``ln_final``, ``text_projection``), so a checkpoint's text
tower loads as it is. The causal attention is plain PyTorch with a mask,
in float32 softmax: JAX computes it outside any kernel, and the port's
attention kernels take no causal mask.

The tokenizer uses the standard ``re`` module where CLIP's (and JAX's)
import the third-party ``regex`` for ``\\p{L}`` and ``\\p{N}``: the two
classes are spelled out as the ranges of code points whose Unicode
category is a letter (``L*``) or a number (``N*``), from ``unicodedata``
(built once, ~0.1 s). Under ``IGNORECASE`` the two modules part only on
characters whose case variants lie in another category, such as the
combining mark U+0345; no class name or concept of the assets has one.
"""

import gzip
import html
import os
import re
import unicodedata
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from semivl_tpu_torch.device import resolve_device
from semivl_tpu_torch.models.layers import LayerNorm, linear, quick_gelu


class _ResidualBlock(nn.Module):
    """One pre-LN block under OpenAI's names: ``ln_1``, ``attn``
    (``in_proj_weight``, ``in_proj_bias``, ``out_proj``), ``ln_2``, ``mlp``
    (``c_fc``, ``c_proj``)."""

    def __init__(self, width, heads, dtype):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(width, 1e-5, dtype)
        self.ln_2 = LayerNorm(width, 1e-5, dtype)
        self.attn = nn.Module()
        self.attn.in_proj_weight = nn.Parameter(
            nn.init.xavier_uniform_(torch.empty(3 * width, width)))
        self.attn.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.attn.out_proj = nn.Linear(width, width)
        self.mlp = nn.Module()
        self.mlp.c_fc = nn.Linear(width, 4 * width)
        self.mlp.c_proj = nn.Linear(4 * width, width)

    def causal_attention(self, y):
        """Packed-QKV attention of each token over itself and the tokens
        before it (JAX ``_causal_attention``)."""
        b, n, c = y.shape
        d = c // self.heads
        qkv = F.linear(y, self.attn.in_proj_weight.to(y.dtype),
                       self.attn.in_proj_bias.to(y.dtype))
        q, k, v = (t.reshape(b, n, self.heads, d).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        logits = torch.einsum('bhqd,bhkd->bhqk', q * d ** -0.5, k).float()
        causal = torch.ones(n, n, dtype=torch.bool, device=y.device).tril()
        logits = logits.masked_fill(~causal, float('-inf'))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum('bhqk,bhkd->bhqd', probs, v)
        return linear(out.transpose(1, 2).reshape(b, n, c),
                      self.attn.out_proj)

    def forward(self, x):
        x = x + self.causal_attention(self.ln_1(x))
        y = self.ln_2(x)
        return x + linear(quick_gelu(linear(y, self.mlp.c_fc)),
                          self.mlp.c_proj)


class CLIPTextTransformer(nn.Module):
    """tokens (B, context) integer -> (B, embed_dim) UN-normalised text
    features, pooled at each row's EOT token (its highest id)."""

    def __init__(self, vocab_size=49408, context_length=77, width=512,
                 layers=12, heads=8, embed_dim=512, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            _ResidualBlock(width, heads, dtype) for _ in range(layers))
        self.ln_final = LayerNorm(width, 1e-5, dtype)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        nn.init.normal_(self.positional_embedding, std=0.01)
        nn.init.normal_(self.text_projection, std=0.02)

    def forward(self, tokens):
        b, n = tokens.shape
        x = (self.token_embedding.weight[tokens].to(self.dtype)
             + self.positional_embedding[:n].to(self.dtype))
        for block in self.transformer.resblocks:
            x = block(x)
        x = self.ln_final(x)
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection.to(pooled.dtype)


# ---------------- BPE tokenizer (CLIP's SimpleTokenizer) ----------------

def default_bpe_path():
    """``SEMIVL_CLIP_BPE``, else the package's assets (where OpenAI's
    ``bpe_simple_vocab_16e6.txt.gz`` would go; it is not in the
    repository)."""
    return os.environ.get(
        'SEMIVL_CLIP_BPE',
        os.path.join(os.path.dirname(__file__), '..', 'assets',
                     'bpe_simple_vocab_16e6.txt.gz'))


@lru_cache()
def bytes_to_unicode():
    """CLIP's reversible byte -> printable character map."""
    bs = (list(range(ord('!'), ord('~') + 1))
          + list(range(ord('\xa1'), ord('\xac') + 1))
          + list(range(ord('\xae'), ord('\xff') + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


# the planes past this one hold no letter and no number (tags, variation
# selectors, private use)
LAST_LETTER_PLANE_END = 0x40000


@lru_cache()
def unicode_class(major):
    """The body of a character class matching the code points whose
    Unicode category starts with ``major`` ('L': ``\\p{L}``, 'N':
    ``\\p{N}``), as ``\\U`` ranges for ``re``."""
    ranges, start, prev = [], None, None
    for cp in range(LAST_LETTER_PLANE_END):
        if unicodedata.category(chr(cp))[0] == major:
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            ranges.append((start, prev))
            start = None
    if start is not None:
        ranges.append((start, prev))
    return ''.join(f'\\U{a:08x}' if a == b else f'\\U{a:08x}-\\U{b:08x}'
                   for a, b in ranges)


def split_pattern():
    """CLIP's pre-tokenisation pattern in ``re`` syntax."""
    letters, numbers = unicode_class('L'), unicode_class('N')
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        rf"|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+",
        re.IGNORECASE)


class SimpleTokenizer:
    """CLIP's BPE tokenizer over a merges file (OpenAI's public
    ``bpe_simple_vocab_16e6.txt.gz``: a header line, then the merges)."""

    def __init__(self, bpe_path=None):
        bpe_path = bpe_path or default_bpe_path()
        if not os.path.isfile(bpe_path):
            raise FileNotFoundError(
                f'CLIP BPE vocab not found at {bpe_path}; put '
                'bpe_simple_vocab_16e6.txt.gz from the openai/CLIP '
                'repository there or set SEMIVL_CLIP_BPE')
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path) as f:
            merges = f.read().decode('utf-8').split('\n')
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + '</w>' for v in vocab]
        for merge in merges:
            vocab.append(''.join(merge))
        vocab.extend(['<|startoftext|>', '<|endoftext|>'])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {'<|startoftext|>': '<|startoftext|>',
                      '<|endoftext|>': '<|endoftext|>'}
        self.pat = split_pattern()

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        pairs = get_pairs(word)
        if not pairs:
            return token + '</w>'
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(
                p, float('inf')))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = ' '.join(word)
        self.cache[token] = out
        return out

    def split(self, text):
        """The cleaned text's pre-tokens (before the byte map and BPE)."""
        text = html.unescape(html.unescape(text)).strip().lower()
        return self.pat.findall(re.sub(r'\s+', ' ', text))

    def encode(self, text):
        bpe_tokens = []
        for token in self.split(text):
            token = ''.join(self.byte_encoder[b]
                            for b in token.encode('utf-8'))
            bpe_tokens.extend(self.encoder[t]
                              for t in self.bpe(token).split(' '))
        return bpe_tokens

    def tokenize(self, texts, context_length=77):
        """(N, context_length) int32 token ids, each row SOT, the text, EOT
        and zeros."""
        if isinstance(texts, str):
            texts = [texts]
        sot = self.encoder['<|startoftext|>']
        eot = self.encoder['<|endoftext|>']
        result = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [sot] + self.encode(text) + [eot]
            if len(toks) > context_length:
                raise ValueError(f'{text!r}: {len(toks)} tokens, more than '
                                 f'{context_length}')
            result[i, :len(toks)] = toks
        return result


@torch.no_grad()
def generate_text_embeddings(class_names, text_params, tokenizer=None,
                             template='a photo of a {}', device=None):
    """Prompts -> L2-normalised (N, embed_dim) float32 embeddings
    (reference model/text_embeddings.py:156-162). ``text_params``: the text
    tower's state dict under OpenAI's names (a CLIP checkpoint's, e.g. from
    ``tools.convert_clip_weights.load_torch_checkpoint``; other keys are
    ignored); runs on the card unless ``device='cpu'`` is given."""
    device = resolve_device(device)
    tokenizer = tokenizer or SimpleTokenizer()
    tokens = tokenizer.tokenize([template.format(c) for c in class_names])
    model = CLIPTextTransformer()
    own = model.state_dict()
    model.load_state_dict({k: torch.as_tensor(np.asarray(text_params[k]))
                           for k in own}, strict=True)
    emb = model.to(device)(torch.from_numpy(tokens).long().to(device))
    emb = emb.float().cpu().numpy()
    return emb / np.linalg.norm(emb, axis=-1, keepdims=True)
