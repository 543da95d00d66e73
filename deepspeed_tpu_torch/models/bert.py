"""The BERT family: the bidirectional post-LN encoder for masked-LM
pretraining (counterpart of ``deepspeed_tpu/models/bert.py``).

The parameter layouts and names are the JAX package's, so weights carry
across one leaf to one tensor (``checkpoint/from_jax.py``): under ``bert``
the tables ``word_embeddings [V, E]``, ``position_embeddings [P, E]`` and
``token_type_embeddings [T, E]``, ``embeddings_ln``; per layer
``layer_i.attention.{query,key,value}.kernel [E, H, D]`` (bias ``[H, D]``),
``attention.output.kernel [H, D, E]``, ``attention_ln``, ``intermediate
[E, I]``, ``output [I, E]`` and ``output_ln``; the ``pooler [E, E]``. The
masked-LM head adds ``transform [E, E]``, ``transform_ln`` and
``decoder_bias [V]``; its decoder is the word table, tied.

Attention is bidirectional. A ``[B, L]`` 0/1 ``attention_mask`` on the
``"flash"`` backend with ``flash_prefix_padding`` (the default) is taken as
right padding: its row sums become the kernels' ``kv_lengths`` (K1 forward,
K4 backward, non-causal). On the ``"xla"`` backend the mask is a boolean
key mask (``normalize_padding_mask``). The flash backend takes no other
mask and raises on one, where JAX falls back to XLA.

Every floating parameter is rounded to the compute dtype where it is used,
as the JAX engine casts the whole tree before ``apply``; the MLM logits are
fp32 (the products of the compute-dtype operands summed in fp32, plus the
fp32 ``decoder_bias``). In training (``deterministic=False``) dropout at
``hidden_dropout_prob`` follows the attention output and the MLP output,
drawn from the caller's generator through one seed per layer, so that a
checkpointed layer (``remat``, ``models/common.maybe_remat``) draws the
same mask when it is recomputed. With ``progressive_layer_drop`` and a
``pld_theta`` each sublayer of layer i is kept with probability ``1 - (i +
1) / n_layers (1 - theta)`` and the post-LN gate is ``LN(x + b f(x) /
keep)`` (JAX ``bert.py:168-171``); ``last_pld_keep`` holds the last draw
([n_layers, 2]). The TPU ``attention_blocks`` belongs to a later slice and
raises ``NotImplementedError``.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.device import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.common import (Dense, LayerNorm, config_from, cross_entropy_loss,
                                               dense_init, dropout, embed_lookup, maybe_remat,
                                               normalize_padding_mask, pld_draws, pld_gate)
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention

#: config fields of the JAX model that belong to later slices of the port,
#: with the value that means "off" and where the slice stands
_LATER_SLICES = {"attention_blocks": (None, "the attention-tuning slice")}

ACTIVATIONS = ("gelu", "gelu_tanh", "gelu_new", "relu")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    # "gelu_tanh"/"gelu_new" (the default, the tanh approximation), "gelu"
    # (exact erf, what HF BERT/DistilBERT checkpoints use) or "relu"
    hidden_act: str = "gelu_tanh"
    hidden_dropout_prob: float = 0.0
    dtype: torch.dtype = torch.float32  # compute dtype; params stay in param_dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    attention_backend: str = "xla"
    # the JAX flash kernel's TPU block geometry; the Hopper kernels have
    # their own tiles
    attention_blocks: Optional[str] = None
    progressive_layer_drop: bool = False
    # [B, L] masks are contiguous right padding, which the flash kernels
    # mask natively through per-row lengths
    flash_prefix_padding: bool = True
    # the flash backend's backward policy (ops/cuda/flash_attention.POLICIES;
    # None: "lse"); the engine's ``attention.policy`` lands here
    attention_policy: Optional[str] = None

    def __post_init__(self):
        for name, (off, where) in _LATER_SLICES.items():
            if getattr(self, name) != off:
                raise NotImplementedError(f"BertConfig.{name}={getattr(self, name)!r} belongs to "
                                          f"{where} of the PyTorch port")
        if self.hidden_act not in ACTIVATIONS:
            raise ValueError(f"unknown hidden_act {self.hidden_act!r}; choose from {list(ACTIVATIONS)}")
        if self.attention_policy is not None:
            from deepspeed_tpu_torch.ops.cuda.flash_attention import check_policy
            check_policy(self.attention_policy)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def dropout(self):
        # the engine reads ``dropout`` to decide whether training draws
        return self.hidden_dropout_prob


BERT_CONFIGS = {
    "test": dict(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=128, max_position_embeddings=128),
    "base": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072),
    "large": dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                  intermediate_size=4096),
    # DistilBERT: 6 layers, no token types, exact gelu
    "distilbert": dict(vocab_size=30522, hidden_size=768, num_hidden_layers=6,
                       num_attention_heads=12, intermediate_size=3072,
                       type_vocab_size=1, hidden_act="gelu"),
}


def get_bert_config(name: str, **overrides) -> BertConfig:
    return config_from(BERT_CONFIGS, BertConfig, name, **overrides)


def _activation(cfg: BertConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.hidden_act == "gelu":
        return F.gelu(h)
    if cfg.hidden_act in ("gelu_tanh", "gelu_new"):
        return F.gelu(h, approximate="tanh")
    return F.relu(h)


class BertSelfAttention(nn.Module):

    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
        self.query = Dense(cfg, (e, h, d), 1, device, bias=True)
        self.key = Dense(cfg, (e, h, d), 1, device, bias=True)
        self.value = Dense(cfg, (e, h, d), 1, device, bias=True)
        self.output = Dense(cfg, (h, d, e), 2, device, bias=True)

    def forward(self, x, attention_mask=None, generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        q, k, v = self.query(x), self.key(x), self.value(x)
        flash = cfg.attention_backend == "flash"
        policy = cfg.attention_policy if flash else None
        if attention_mask is not None and attention_mask.dim() == 2 and flash and cfg.flash_prefix_padding:
            out = dot_product_attention(q, k, v, backend="flash", causal=False, policy=policy,
                                        kv_lengths=attention_mask.sum(dim=-1).to(torch.int32))
        else:
            out = dot_product_attention(q, k, v, backend=cfg.attention_backend, causal=False,
                                        mask=normalize_padding_mask(attention_mask), policy=policy)
        return dropout(self.output(out), cfg.hidden_dropout_prob, generator)


class BertLayer(nn.Module):
    """The post-LN encoder layer (original BERT ordering)."""

    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg, device)
        self.attention_ln = LayerNorm(cfg, cfg.hidden_size, "layer_norm_eps", device)
        self.intermediate = Dense(cfg, (cfg.hidden_size, cfg.intermediate_size), 1, device, bias=True)
        self.output = Dense(cfg, (cfg.intermediate_size, cfg.hidden_size), 1, device, bias=True)
        self.output_ln = LayerNorm(cfg, cfg.hidden_size, "layer_norm_eps", device)

    def forward(self, x, attention_mask=None, dropout_seed: Optional[int] = None,
                pld_keep: Optional[float] = None, pld_mask: Optional[torch.Tensor] = None):
        """``dropout_seed`` seeds this layer's dropout (None: no draws);
        with ``pld_keep`` and ``pld_mask`` (bool [2]: attention, then the
        MLP) a sublayer whose flag is False adds nothing and a kept one adds
        its output over ``pld_keep``."""
        gen = None
        if dropout_seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(dropout_seed)
        attn = self.attention(x, attention_mask, gen)
        x = self.attention_ln(x + pld_gate(attn, pld_keep, pld_mask, 0))
        h = self.output(_activation(self.cfg, self.intermediate(x)))
        h = dropout(h, self.cfg.hidden_dropout_prob, gen)
        return self.output_ln(x + pld_gate(h, pld_keep, pld_mask, 1))


class BertModel(nn.Module):
    """Embeddings, the encoder stack and the pooler on [CLS]. ``model(ids,
    token_type_ids, attention_mask)`` -> ``(hidden [B, L, E], pooled [B,
    E], word_embeddings)``, the word table in the compute dtype for a head
    to tie its decoder to."""

    #: the numbered blocks (``runtime/zero/param_offload.py``)
    streamed_block_prefixes = ("layer_",)

    def __init__(self, config: BertConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dev = self.device = resolve_device(device)
        e, pd = cfg.hidden_size, cfg.param_dtype
        self.word_embeddings = nn.Parameter(torch.empty((cfg.vocab_size, e), dtype=pd, device=dev))
        self.position_embeddings = nn.Parameter(torch.empty((cfg.max_position_embeddings, e),
                                                            dtype=pd, device=dev))
        self.token_type_embeddings = nn.Parameter(torch.empty((cfg.type_vocab_size, e), dtype=pd,
                                                              device=dev))
        self.embeddings_ln = LayerNorm(cfg, cfg.hidden_size, "layer_norm_eps", dev)
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layer_{i}", BertLayer(cfg, dev))
        self.pooler = Dense(cfg, (e, e), 1, dev, bias=True)
        self.last_pld_keep: Optional[torch.Tensor] = None
        if dev.type != "meta":  # a skeleton for kernel injection draws nothing
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random init with the JAX model's distributions (normal 0.02 for
        the three embedding tables and every kernel; zero biases, unit norm
        scales), from ``generator`` (a fresh one seeded 0 when None)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        for name, t in self.named_parameters():
            if name.endswith("kernel") or name.endswith("embeddings"):
                dense_init()(t, generator)

    @property
    def blocks(self):
        return [getattr(self, f"layer_{i}") for i in range(self.config.num_hidden_layers)]

    def forward(self, input_ids: torch.Tensor, token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, pld_theta: Optional[float] = None):
        cfg = self.config
        dt = cfg.dtype
        ids = input_ids.to(self.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        if attention_mask is not None:
            attention_mask = attention_mask.to(self.device)
        n = cfg.num_hidden_layers
        seeds = [None] * n
        if not deterministic and cfg.hidden_dropout_prob > 0.0:
            if generator is None:
                raise ValueError("training with dropout needs a generator")
            seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).tolist()
        keeps, pld = [None] * n, None
        if cfg.progressive_layer_drop and pld_theta is not None and not deterministic:
            if generator is None:
                raise ValueError("progressive layer drop in training needs a generator")
            keeps, pld = pld_draws(n, pld_theta, generator, self.device)
            self.last_pld_keep = pld
        word = self.word_embeddings.to(dt)  # once: the decoder's tie shares its gradient
        x = (embed_lookup(word, ids) + self.position_embeddings.to(dt)[None, :ids.shape[1]]
             + embed_lookup(self.token_type_embeddings.to(dt), token_type_ids.to(self.device)))
        x = self.embeddings_ln(x)
        for i, layer in enumerate(self.blocks):
            run = maybe_remat(layer, cfg, i)
            x = run(x, attention_mask, seeds[i], keeps[i], None if pld is None else pld[i])
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled, word


class BertForMaskedLM(nn.Module):
    """The MLM head on :class:`BertModel`, its decoder tied to the word
    table: ``model(ids, token_type_ids, attention_mask)`` -> fp32 logits
    ``[B, L, V]``."""

    streamed_block_prefixes = ("layer_",)

    def __init__(self, config: BertConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dev = self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.bert = BertModel(cfg, dev, generator)
        self.transform = Dense(cfg, (cfg.hidden_size, cfg.hidden_size), 1, dev, bias=True)
        dense_init()(self.transform.kernel, generator)
        self.transform_ln = LayerNorm(cfg, cfg.hidden_size, "layer_norm_eps", dev)
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size, dtype=cfg.param_dtype, device=dev))

    @property
    def last_pld_keep(self) -> Optional[torch.Tensor]:
        return self.bert.last_pld_keep

    def forward(self, input_ids: torch.Tensor, token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, pld_theta: Optional[float] = None):
        x, _, word = self.bert(input_ids, token_type_ids, attention_mask, deterministic=deterministic,
                               generator=generator, pld_theta=pld_theta)
        x = self.transform_ln(_activation(self.config, self.transform(x)))
        return tied_logits(x, word) + self.decoder_bias.float()


class _Bf16TiedLogits(torch.autograd.Function):
    """``x @ word.T`` of bf16 operands in fp32 on the tensor cores: cuBLAS's
    bf16 product with an fp32 result (``torch.mm(..., out_dtype=float32)``)
    multiplies exactly and sums in fp32, as an fp32 product of the same
    values does. The backward's cotangent is fp32: it is split into three
    bf16 pieces whose sum holds all its 24 bits, and each gradient sums the
    pieces' fp32 products before its one rounding to bf16."""

    @staticmethod
    def forward(ctx, x, word):
        ctx.save_for_backward(x, word)
        out = torch.mm(x.reshape(-1, x.shape[-1]), word.t(), out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], word.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, word = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        rest = g.reshape(-1, word.shape[0]).float()
        dx = dw = None
        for i in range(3):
            piece = rest.to(torch.bfloat16)
            px = torch.mm(piece, word, out_dtype=torch.float32)
            pw = torch.mm(piece.t(), x2, out_dtype=torch.float32)
            dx = px if dx is None else dx.add_(px)
            dw = pw if dw is None else dw.add_(pw)
            if i < 2:
                rest = rest - piece  # exact in fp32
        return dx.reshape(x.shape).to(x.dtype), dw.to(word.dtype)


def tied_logits(x: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """fp32 logits ``x @ word.T`` of the compute-dtype operands: their exact
    products summed in fp32 (JAX's einsum with
    ``preferred_element_type=float32``). bf16 operands on CUDA take the
    tensor cores (:class:`_Bf16TiedLogits`); anything else multiplies fp32
    copies."""
    if x.is_cuda and x.dtype == torch.bfloat16 and word.dtype == torch.bfloat16:
        return _Bf16TiedLogits.apply(x, word)
    return x.float() @ word.float().t()


def bert_mlm_loss(logits: torch.Tensor, batch) -> torch.Tensor:
    """Masked-LM cross entropy: ``labels == -100`` positions are ignored."""
    labels = batch["labels"] if isinstance(batch, dict) else batch
    return cross_entropy_loss(logits, labels)


def param_shapes(cfg: BertConfig) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """State-dict key -> (shape, dtype) of :class:`BertForMaskedLM`."""
    e, h, d, i = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim, cfg.intermediate_size
    pd = cfg.param_dtype
    norm = {"scale": ((e,), pd), "bias": ((e,), pd)}
    out = {"decoder_bias": ((cfg.vocab_size,), pd),
           "bert.word_embeddings": ((cfg.vocab_size, e), pd),
           "bert.position_embeddings": ((cfg.max_position_embeddings, e), pd),
           "bert.token_type_embeddings": ((cfg.type_vocab_size, e), pd)}

    def add(prefix, shapes):
        out.update({f"{prefix}.{k}": v for k, v in shapes.items()})

    def dense(kshape, n_contract):
        return {"kernel": (kshape, pd), "bias": (kshape[n_contract:], pd)}

    add("bert.embeddings_ln", norm)
    for n in range(cfg.num_hidden_layers):
        p = f"bert.layer_{n}"
        for proj in ("query", "key", "value"):
            add(f"{p}.attention.{proj}", dense((e, h, d), 1))
        add(f"{p}.attention.output", dense((h, d, e), 2))
        add(f"{p}.attention_ln", norm)
        add(f"{p}.intermediate", dense((e, i), 1))
        add(f"{p}.output", dense((i, e), 1))
        add(f"{p}.output_ln", norm)
    add("bert.pooler", dense((e, e), 1))
    add("transform", dense((e, e), 1))
    add("transform_ln", norm)
    return out
