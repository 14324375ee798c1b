"""Machine-translation app: tokenizer, training, evaluation, generation and
BLEU (counterpart of flashattn_tpu/training/translation.py).

Two architectures over the same data: ``arch="decoder_only"`` trains a
:class:`DecoderLM` over the concatenated ``<src ids> <eos_src> <tgt ids>
<eos_tgt> <pad>...`` stream with the loss on target tokens only;
``arch="seq2seq"`` trains an :class:`EncoderDecoderLM` on separate source
and target streams.  Data is IWSLT14 de-en through Hugging Face
``datasets`` where it loads, the vendored de-en corpus
(``dataset_name="deen-fixture"``), or a synthetic de->en corpus as the
offline fallback.  A byte-level BPE tokenizer is trained on the train
split in the work directory.  Training groups ``steps_per_dispatch``
batches into one ``make_train_scan`` call (Adam under a warmup-cosine
schedule, global-norm clipping); evaluation reports the masked validation
loss and sacrebleu corpus BLEU of greedy (or beam, or engine) generations
on the test split.  Checkpoints (:mod:`..utils.checkpoint`) are written
after every epoch; the decoder-only stream can come from the native C++
loader (:mod:`..utils.native_loader`).

    python -m flashattn_tpu_torch.training.translation --arch seq2seq \\
        --dataset-name deen-fixture

The app runs on the CUDA device unless ``--device cpu`` (``MTConfig.device``)
asks for the CPU.  ``tokenizers``, ``transformers``, ``sacrebleu``, ``tqdm``
and ``datasets`` are imported inside the functions that use them, so
importing this module needs none of them; ``run()`` needs the first four.
A JAX key becomes a ``torch.Generator`` seeded from ``config.seed``, from
which the models draw their dropout seeds; with the dropout off, the same
config gives the JAX app's losses and generations.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.seq2seq import EncoderDecoderLM
from ..models.transformer import DecoderLM
from ..nn import functional as F
from ..optim import Adam, warmup_cosine
from .trainer import (_masked_mean, lm_loss, make_eval_step,
                      make_mixed_precision_loss, make_train_scan)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MTConfig:
    dataset_name: str = "bbaaaa/iwslt14-de-en-preprocess"
    # "decoder_only": DecoderLM over the concatenated src<eos>tgt<eos>
    # stream; "seq2seq": EncoderDecoderLM (n_layer encoder and n_layer
    # decoder blocks, cross-attention, separate src / tgt streams)
    arch: str = "decoder_only"
    model_max_length: int = 40
    n_epochs: int = 1
    batch_size: int = 128
    # None: 0.005 decoder-only, 0.002 seq2seq (the JAX app's per-arch
    # defaults; an explicit value is never overridden)
    learning_rate: Optional[float] = None
    # global-norm gradient clipping; 0 disables
    grad_clip: float = 1.0
    # "cosine" = linear warmup (5% of steps) + cosine decay; "constant"
    lr_schedule: str = "cosine"
    # save model + optimizer state every epoch under <workdir>/ckpt;
    # resume from there if asked
    save_checkpoints: bool = True
    resume: bool = False
    samples_per_epoch: int = 20000
    n_vocab: int = 10000
    n_embd: int = 256
    n_head: int = 8
    n_layer: int = 4
    p_dropout: float = 0.1
    seed: int = 11111
    # evaluation decoding: "greedy", "beam" (beam_size hypotheses, GNMT
    # length penalty; decoder-only) or "engine" (the continuous-batching
    # engine with prompt-lookup speculation; greedy-exact)
    decode: str = "greedy"
    beam_size: int = 4
    attn_impl: str = "flash"
    use_fused_layernorm: bool = True
    # checkpoint each transformer block (recompute in the backward)
    remat: bool = False
    # bf16 compute over f32 master weights (make_mixed_precision_loss)
    mixed_precision: bool = False
    workdir: Optional[str] = None
    synthetic_size: int = 20000  # offline fallback corpus size
    use_native_loader: bool = True  # C++ collate + prefetch (native/)
    # batches per make_train_scan call
    steps_per_dispatch: int = 8
    # the torch device of the model and its batches; None = "cuda"
    device: Optional[str] = None

    def resolve_workdir(self) -> str:
        wd = self.workdir or (
            f"workdir_vocab{self.n_vocab}_lr{self.learning_rate}_embd{self.n_embd}"
        )
        os.makedirs(wd, exist_ok=True)
        return wd


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

_SYLLABLES = ["ba", "de", "ki", "lo", "mu", "ne", "pa", "ri", "so", "tu",
              "va", "ze", "gl", "shta", "kro", "fen"]


def _make_lexicon(n_words: int, rng: random.Random):
    """Deterministic de->en word lexicon from syllable soup."""
    lex = {}
    seen = set()
    while len(lex) < n_words:
        w = "".join(rng.choice(_SYLLABLES) for _ in range(rng.randint(2, 3)))
        if w in seen:
            continue
        seen.add(w)
        lex[w + "en"] = w + "ish"  # "german" suffix -> "english" suffix
    return lex


def make_synthetic_dataset(n_examples: int, seed: int = 0):
    """Parallel corpus with a learnable structure: word-level lexicon plus a
    deterministic reorder (first two words swapped in the target)."""
    rng = random.Random(seed)
    lex = _make_lexicon(200, rng)
    src_words = list(lex.keys())
    examples = []
    for _ in range(n_examples):
        n = rng.randint(3, 9)
        src = [rng.choice(src_words) for _ in range(n)]
        tgt = [lex[w] for w in src]
        if len(tgt) >= 2:
            tgt[0], tgt[1] = tgt[1], tgt[0]
        examples.append({"de": " ".join(src), "en": " ".join(tgt)})
    return examples


def get_dataset(dataset_name: str, model_max_length: int,
                synthetic_size: int = 20000, seed: int = 0):
    """(splits, src_key, tgt_key): IWSLT14 de-en through Hugging Face
    ``datasets``, the vendored de-en corpus (``"deen-fixture"``: 80 / 10 /
    10 of the shuffled pairs, no length filter), or, where the download
    fails, the synthetic corpus.  The first and last are filtered to pairs
    of fewer than ``model_max_length`` words, the test split cut to 100."""
    src_key, tgt_key = "de", "en"
    if dataset_name == "deen-fixture":
        from .deen_fixture import make_fixture_dataset

        all_ex = make_fixture_dataset(seed)
        n_val = max(len(all_ex) // 10, 1)
        dataset = {
            "train": all_ex[: -2 * n_val],
            "validation": all_ex[-2 * n_val: -n_val],
            "test": all_ex[-n_val:],
        }
        print(json.dumps({"data_size": {s: len(dataset[s]) for s in dataset}}))
        return dataset, src_key, tgt_key
    try:
        import datasets as hf_datasets

        dataset = {
            split: hf_datasets.load_dataset(dataset_name, split=split)["translation"]
            for split in ["train", "validation", "test"]
        }
    except Exception as e:  # offline
        print(f"[translation] HF dataset unavailable ({type(e).__name__}); "
              f"using built-in synthetic corpus")
        all_ex = make_synthetic_dataset(synthetic_size + 1100, seed)
        dataset = {
            "train": all_ex[:synthetic_size],
            "validation": all_ex[synthetic_size:synthetic_size + 1000],
            "test": all_ex[synthetic_size + 1000:],
        }

    dataset = {
        split: [ex for ex in dataset[split]
                if len(ex[src_key].split()) + len(ex[tgt_key].split())
                < model_max_length]
        for split in dataset
    }
    dataset["test"] = dataset["test"][:100]
    print(json.dumps({"data_size": {s: len(dataset[s]) for s in dataset}}))
    return dataset, src_key, tgt_key


def get_tokenizer(examples, vocab_size: int, src_key: str, tgt_key: str,
                  workdir: str):
    """Byte-level BPE trained on the corpus with ``<eos_{src}>``,
    ``<eos_{tgt}>`` and ``<pad>`` specials, saved in ``workdir`` and loaded
    back through ``transformers.AutoTokenizer``."""
    from tokenizers import ByteLevelBPETokenizer

    tokenizer = ByteLevelBPETokenizer()
    tokenizer.train_from_iterator(
        [[ex[src_key], ex[tgt_key]] for ex in examples],
        vocab_size=vocab_size,
        special_tokens=[f"<eos_{src_key}>", f"<eos_{tgt_key}>", "<pad>"],
    )
    tokenizer.save(f"{workdir}/tokenizer.json")
    with open(f"{workdir}/config.json", "w") as f:
        json.dump({"model_type": "gpt2"}, f)

    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(
        workdir, eos_token=None, bos_token=None, pad_token=None, unk_token=None
    )


def collate_batch(examples, src_key, tgt_key, tokenizer, model_max_length):
    """Tokenize and pad to ``model_max_length`` (decoder-only stream).

    Returns numpy arrays: input_ids / labels (B, L-1) int32 and
    label_token_weights (B, L-1) float32 (the loss on target tokens only).
    """
    token_ids, tgt_token_mask = [], []
    pad_token_id = tokenizer.vocab["<pad>"]
    for ex in examples:
        ids_src = tokenizer(f"{ex[src_key]}<eos_{src_key}>")["input_ids"]
        ids_tgt = tokenizer(f"{ex[tgt_key]}<eos_{tgt_key}>")["input_ids"]
        ids = (ids_src + ids_tgt)[:model_max_length]
        mask = ([0] * len(ids_src) + [1] * len(ids_tgt))[:model_max_length]
        pad = [pad_token_id] * (model_max_length - len(ids))
        token_ids.append(ids + pad)
        tgt_token_mask.append(mask + [0] * len(pad))

    token_ids = np.asarray(token_ids, np.int32)
    tgt_token_mask = np.asarray(tgt_token_mask, np.float32)
    return {
        "input_ids": token_ids[:, :-1],
        "labels": token_ids[:, 1:],
        "label_token_weights": tgt_token_mask[:, 1:],
    }


def collate_batch_seq2seq(examples, src_key, tgt_key, tokenizer,
                          model_max_length):
    """Seq2seq collate: separate source and target streams.

    The decoder is primed with ``<eos_src>`` as BOS (it never occurs in
    target text); labels are the target ids ending in ``<eos_tgt>``.
    Returns src / src_lens plus input_ids (decoder input), labels and
    label_token_weights shaped like the decoder stream.
    """
    pad_id = tokenizer.vocab["<pad>"]
    bos_id = tokenizer.vocab[f"<eos_{src_key}>"]
    src_arr = np.full((len(examples), model_max_length), pad_id, np.int32)
    src_lens = np.zeros((len(examples),), np.int32)
    tgt_in = np.full((len(examples), model_max_length), pad_id, np.int32)
    labels = np.full((len(examples), model_max_length), pad_id, np.int32)
    weights = np.zeros((len(examples), model_max_length), np.float32)
    for r, ex in enumerate(examples):
        ids_src = tokenizer(f"{ex[src_key]}<eos_{src_key}>")["input_ids"]
        ids_src = ids_src[:model_max_length]
        ids_tgt = tokenizer(f"{ex[tgt_key]}<eos_{tgt_key}>")["input_ids"]
        ids_tgt = ids_tgt[:model_max_length]
        src_arr[r, :len(ids_src)] = ids_src
        src_lens[r] = len(ids_src)
        tgt_in[r, :len(ids_tgt)] = [bos_id] + ids_tgt[:-1]
        labels[r, :len(ids_tgt)] = ids_tgt
        weights[r, :len(ids_tgt)] = 1.0
    return {"src": src_arr, "src_lens": src_lens, "input_ids": tgt_in,
            "labels": labels, "label_token_weights": weights}


def seq2seq_loss(model, inputs, targets, loss_mask=None, generator=None):
    """Masked cross entropy for :class:`EncoderDecoderLM`; ``inputs`` is the
    ``{"src", "src_lens", "tgt_in"}`` dict that the seq2seq collate and
    scan thread through the trainer's tokens slot.  As in JAX, the loss is
    taken in the logits' dtype."""
    logits = model(inputs["src"], inputs["tgt_in"], inputs["src_lens"],
                   generator=generator)
    n_vocab = logits.shape[-1]
    losses = F.softmax_loss(logits.reshape(-1, n_vocab),
                            targets.reshape(-1)).reshape(targets.shape)
    return _masked_mean(losses, loss_mask)


# ---------------------------------------------------------------------------
# Train / eval / generate
# ---------------------------------------------------------------------------


def tokenize_corpus(examples, tokenizer, src_key, tgt_key):
    """Tokenize once, for the native loader."""
    return [
        (tokenizer(f"{ex[src_key]}<eos_{src_key}>")["input_ids"],
         tokenizer(f"{ex[tgt_key]}<eos_{tgt_key}>")["input_ids"])
        for ex in examples
    ]


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _tokens_slot(batch: dict, dev: torch.device):
    """The trainer's tokens slot of a collated (or stacked) batch, on
    ``dev``: the seq2seq dict ``{"src", "src_lens", "tgt_in"}``, or the
    decoder-only input ids."""
    to = lambda name: torch.from_numpy(batch[name]).to(dev)
    if "src" in batch:
        return {"src": to("src"), "src_lens": to("src_lens"),
                "tgt_in": to("input_ids")}
    return to("input_ids")


def _dispatch_chunk(model, opt_state, scan_fn, batches, generator):
    """Stack K collated batches and run them as ONE ``make_train_scan``
    call.  Returns (model, opt_state, generator, losses (K,) numpy, tokens
    in the chunk)."""
    dev = _device(model)
    stacked = {name: np.stack([b[name] for b in batches])
               for name in batches[0]}
    tokens = _tokens_slot(stacked, dev)
    if isinstance(tokens, dict):
        n_tok = tokens["tgt_in"].numel() + tokens["src"].numel()
    else:
        n_tok = tokens.numel()
    labels = torch.from_numpy(stacked["labels"]).to(dev)
    weights = torch.from_numpy(stacked["label_token_weights"]).to(dev)
    model, opt_state, losses = scan_fn(model, opt_state, tokens, labels,
                                       weights, generator)
    return model, opt_state, generator, losses.float().cpu().numpy(), n_tok


def _chunk_sizes(n_steps: int, steps_per_dispatch: int) -> List[int]:
    """Full chunks plus one tail chunk, so that no step is dropped."""
    spd = max(1, min(steps_per_dispatch, n_steps))
    sizes = [spd] * (n_steps // spd)
    if n_steps % spd:
        sizes.append(n_steps % spd)
    return sizes


def train_epoch_native(model, opt_state, scan_fn, loader, n_steps, generator,
                       steps_per_dispatch=8, desc=""):
    """One epoch over the C++ prefetching loader, steps grouped into
    ``make_train_scan`` calls.  Returns (model, opt_state, generator, mean
    train loss)."""
    import tqdm

    losses = []
    prog = tqdm.tqdm(_chunk_sizes(n_steps, steps_per_dispatch),
                     desc=f"Training ({desc})")
    for size in prog:
        batches = [loader.next_batch() for _ in range(size)]
        t0 = time.time()
        model, opt_state, generator, chunk_losses, n_tok = _dispatch_chunk(
            model, opt_state, scan_fn, batches, generator)
        dt = time.time() - t0
        losses.extend(chunk_losses.tolist())
        prog.set_postfix(loss=f"{chunk_losses[-1]:.4f}",
                         tokens_per_sec=f"{n_tok / dt:,.0f}")
    mean = float(np.mean(losses)) if losses else float("nan")
    return model, opt_state, generator, mean


def train_epoch(model, opt, opt_state, scan_fn, examples, n_samples, collate_fn,
                batch_size, generator, steps_per_dispatch=8, desc=""):
    """One epoch: shuffle with Python's ``random`` (seeded by ``run``, as
    JAX's app is, so that both see the batches in the same order), take
    ``n_samples``, drop the ragged tail and train in chunks of
    ``steps_per_dispatch`` batches.  Returns (model, opt_state, generator,
    mean train loss)."""
    import tqdm

    examples = list(examples)
    random.shuffle(examples)
    examples = examples[:n_samples]
    n_steps = len(examples) // batch_size

    losses = []
    step0 = 0
    prog = tqdm.tqdm(_chunk_sizes(n_steps, steps_per_dispatch),
                     desc=f"Training ({desc})")
    for size in prog:
        start = step0 * batch_size
        step0 += size
        batches = [
            collate_fn(examples=examples[start + j * batch_size:
                                         start + (j + 1) * batch_size])
            for j in range(size)
        ]
        t0 = time.time()
        model, opt_state, generator, chunk_losses, n_tok = _dispatch_chunk(
            model, opt_state, scan_fn, batches, generator)
        dt = time.time() - t0
        losses.extend(chunk_losses.tolist())
        prog.set_postfix(loss=f"{chunk_losses[-1]:.4f}",
                         tokens_per_sec=f"{n_tok / dt:,.0f}")
    mean = float(np.mean(losses)) if losses else float("nan")
    return model, opt_state, generator, mean


def evaluate_loss(model, eval_fn, examples, batch_size, collate_fn, desc=""):
    """Average masked loss over whole batches of ``examples`` (all of them
    as one batch when there are fewer than ``batch_size``)."""
    import tqdm

    dev = _device(model)
    losses = []
    usable = (len(examples) // batch_size) * batch_size
    if usable == 0:
        usable, batch_size = len(examples), len(examples)
    for i in tqdm.trange(0, usable, batch_size, desc=f"Evaluating ({desc})"):
        batch = collate_fn(examples=examples[i:i + batch_size])
        loss = eval_fn(model, _tokens_slot(batch, dev),
                       torch.from_numpy(batch["labels"]).to(dev),
                       torch.from_numpy(batch["label_token_weights"]).to(dev))
        losses.append(float(loss))
    return float(np.mean(losses))


def _source_ids(tokenizer, ex, src_key, model_max_length):
    ids = tokenizer(f"{ex[src_key]}<eos_{src_key}>")["input_ids"]
    return ids[:model_max_length]


def generate(model, examples, src_key, tgt_key, tokenizer, model_max_length,
             desc="", batch_size: int = 32, beam_size: Optional[int] = None):
    """Batched KV-cached generation of a :class:`DecoderLM` conditioned on
    the source: each prompt is padded to ``model_max_length`` and extended
    by ``model_max_length`` tokens, cut at the first ``<eos_tgt>``.
    ``beam_size`` > 1 switches from greedy to beam search."""
    import tqdm

    from .generate import beam_search_generate, greedy_generate

    eos_tgt = tokenizer.vocab[f"<eos_{tgt_key}>"]
    pad_id = tokenizer.vocab["<pad>"]
    dev = _device(model)
    gen_sents: List[str] = []
    for i in tqdm.trange(0, len(examples), batch_size, desc=f"Generating {desc}"):
        chunk = examples[i:i + batch_size]
        prompts = [_source_ids(tokenizer, ex, src_key, model_max_length)
                   for ex in chunk]
        plens = [len(ids) for ids in prompts]
        buf = np.full((len(chunk), model_max_length), pad_id, np.int32)
        for r, ids in enumerate(prompts):
            buf[r, :len(ids)] = ids
        buf_t = torch.from_numpy(buf).to(dev)
        plen_t = torch.tensor(plens, device=dev)
        if beam_size and beam_size > 1:
            out = beam_search_generate(model, buf_t, plen_t, model_max_length,
                                       beam_size, eos_tgt)
        else:
            out = greedy_generate(model, buf_t, plen_t, model_max_length,
                                  eos_tgt)
        out = out.cpu().numpy()
        for r, plen in enumerate(plens):
            toks = out[r, plen:]
            stop = np.where(toks == eos_tgt)[0]
            toks = toks[:stop[0]] if len(stop) else toks
            gen_sents.append(tokenizer.decode(toks.tolist()))
    return gen_sents


def generate_engine(model, examples, src_key, tgt_key, tokenizer,
                    model_max_length, desc="", max_batch: int = 32,
                    prompt_lookup: int = 3):
    """Generation through the continuous-batching engine: paged KV pools,
    admission as rows finish and prompt-lookup speculation.  Greedy-exact,
    so the sentences are :func:`generate`'s; the model's mode is restored
    after."""
    from ..serving.engine import ContinuousBatchingEngine

    eos_tgt = tokenizer.vocab[f"<eos_{tgt_key}>"]
    capacity = 2 * model_max_length
    page = 32
    was_training = model.training
    try:
        eng = ContinuousBatchingEngine(
            model.eval(), max_batch=max_batch, page_size=page,
            pages_per_seq=-(-capacity // page) + 1,
            prompt_lookup=prompt_lookup)
        reqs = []
        for ex in examples:
            ids = _source_ids(tokenizer, ex, src_key, model_max_length)
            # generate()'s span: up to 2 * model_max_length - prompt tokens
            reqs.append(eng.submit(ids, 2 * model_max_length - len(ids),
                                   eos_id=eos_tgt))
        eng.run(max_steps=10_000_000)
        print(f"engine stats {desc}: {eng.stats()}")
    finally:
        model.train(was_training)
    gen_sents = []
    for r in reqs:
        toks = r.generated
        if toks and toks[-1] == eos_tgt:
            toks = toks[:-1]
        gen_sents.append(tokenizer.decode(toks))
    return gen_sents


def generate_seq2seq(model, examples, src_key, tgt_key, tokenizer,
                     model_max_length, desc="", batch_size: int = 32):
    """Encoder-decoder generation: per batch, one encoder pass, the cross
    K/V once and ``model_max_length`` cached greedy steps
    (:func:`..training.generate.greedy_generate_seq2seq`), each row cut at
    its first ``<eos_tgt>``."""
    import tqdm

    from .generate import greedy_generate_seq2seq

    eos_tgt = tokenizer.vocab[f"<eos_{tgt_key}>"]
    bos_id = tokenizer.vocab[f"<eos_{src_key}>"]
    pad_id = tokenizer.vocab["<pad>"]
    dev = _device(model)
    gen_sents: List[str] = []
    for i in tqdm.trange(0, len(examples), batch_size,
                         desc=f"Generating {desc}"):
        chunk = examples[i:i + batch_size]
        buf = np.full((len(chunk), model_max_length), pad_id, np.int32)
        plens = []
        for r, ex in enumerate(chunk):
            ids = _source_ids(tokenizer, ex, src_key, model_max_length)
            buf[r, :len(ids)] = ids
            plens.append(len(ids))
        out = greedy_generate_seq2seq(
            model, torch.from_numpy(buf).to(dev),
            torch.tensor(plens, device=dev), model_max_length, bos_id,
            eos_tgt).cpu().numpy()
        for row in out:
            stop = np.where(row == eos_tgt)[0]
            toks = row[:stop[0]] if len(stop) else row
            gen_sents.append(tokenizer.decode(toks.tolist()))
    return gen_sents


def evaluate_bleu(examples, gen_sents, tgt_key):
    """sacrebleu corpus BLEU of ``gen_sents`` against the targets."""
    from sacrebleu import BLEU

    return {
        "bleu": BLEU().corpus_score(
            hypotheses=gen_sents,
            references=[[ex[tgt_key] for ex in examples]],
        ).score
    }


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------


def _build_model(config: MTConfig, seq2seq: bool, device: torch.device):
    kw = dict(n_vocab=config.n_vocab, n_embd=config.n_embd,
              n_head=config.n_head, n_positions=config.model_max_length,
              p_dropout=config.p_dropout, attn_impl=config.attn_impl,
              use_fused_layernorm=config.use_fused_layernorm,
              remat=config.remat,
              generator=torch.Generator().manual_seed(config.seed),
              device=device)
    if seq2seq:
        return EncoderDecoderLM(n_encoder_layer=config.n_layer,
                                n_decoder_layer=config.n_layer, **kw)
    return DecoderLM(n_layer=config.n_layer, **kw)


def _dump(obj, path: str, **kw) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, **kw)


def run(config: MTConfig) -> Dict:
    """Train ``config.n_epochs`` epochs; after each, the validation loss,
    the test generations (``<workdir>/gen_epoch{e}.json``), BLEU
    (``<workdir>/eval_results_epoch{e}.json``) and, with
    ``save_checkpoints``, a checkpoint.  Returns the last epoch's results:
    {"epoch", "train_loss", "validation_loss", "bleu"}."""
    if config.learning_rate is None:
        lr0 = 0.002 if config.arch == "seq2seq" else 0.005
        config = dataclasses.replace(config, learning_rate=lr0)
        print(f"[translation] learning_rate -> {lr0} ({config.arch} default)")

    workdir = config.resolve_workdir()
    np.random.seed(config.seed)
    random.seed(config.seed)

    dataset, src_key, tgt_key = get_dataset(
        config.dataset_name, config.model_max_length,
        config.synthetic_size, config.seed,
    )
    tokenizer = get_tokenizer(dataset["train"], config.n_vocab, src_key,
                              tgt_key, workdir)
    seq2seq = config.arch == "seq2seq"
    collate_fn = functools.partial(
        collate_batch_seq2seq if seq2seq else collate_batch,
        src_key=src_key, tgt_key=tgt_key, tokenizer=tokenizer,
        model_max_length=config.model_max_length,
    )

    device = torch.device(config.device or "cuda")
    model = _build_model(config, seq2seq, device).train()
    if config.lr_schedule == "cosine":
        total_steps = max(1, config.n_epochs
                          * (config.samples_per_epoch // config.batch_size))
        lr = warmup_cosine(config.learning_rate,
                           warmup_steps=max(10, total_steps // 20),
                           total_steps=total_steps)
    else:
        lr = config.learning_rate
    opt = Adam(lr=lr)
    opt_state = opt.init(model)
    loss_fn = seq2seq_loss if seq2seq else lm_loss
    # bf16 forward / backward over f32 masters; evaluation and generation
    # stay f32
    train_loss_fn = (make_mixed_precision_loss(loss_fn)
                     if config.mixed_precision else loss_fn)
    scan_fn = make_train_scan(opt, train_loss_fn,
                              grad_clip=config.grad_clip or None)
    eval_fn = make_eval_step(loss_fn)
    generator = torch.Generator().manual_seed(config.seed)

    loader = None
    if config.use_native_loader and seq2seq:
        print("[translation] native loader emits the concatenated "
              "decoder-only stream; seq2seq uses the Python collate")
    elif config.use_native_loader:
        try:
            from ..utils.native_loader import NativeDataLoader

            corpus = tokenize_corpus(dataset["train"], tokenizer, src_key,
                                     tgt_key)
            loader = NativeDataLoader(
                corpus, tokenizer.vocab["<pad>"], config.model_max_length,
                config.batch_size, seed=config.seed,
            )
        except OSError as e:
            print(f"[translation] native loader unavailable "
                  f"({type(e).__name__}: {e}); using Python collate")

    start_epoch = 0
    ckpt_dir = os.path.join(workdir, "ckpt")
    if config.resume and os.path.isdir(ckpt_dir):
        from ..utils.checkpoint import restore_checkpoint

        model, opt_state, start_epoch = restore_checkpoint(
            ckpt_dir, model, opt_state)
        print(f"[translation] resumed from {ckpt_dir} at epoch {start_epoch}")

    results = {}
    for epoch in range(start_epoch, config.n_epochs):
        desc = f"epoch_{epoch}"
        model.train()
        if loader is not None:
            n_steps = min(config.samples_per_epoch,
                          len(dataset["train"])) // config.batch_size
            model, opt_state, generator, train_loss = train_epoch_native(
                model, opt_state, scan_fn, loader, n_steps, generator,
                config.steps_per_dispatch, desc,
            )
        else:
            model, opt_state, generator, train_loss = train_epoch(
                model, opt, opt_state, scan_fn, dataset["train"],
                config.samples_per_epoch, collate_fn, config.batch_size,
                generator, config.steps_per_dispatch, desc,
            )
        val_loss = evaluate_loss(model, eval_fn, dataset["validation"],
                                 config.batch_size, collate_fn, desc)
        print(f"Epoch {epoch}: train_loss={train_loss:.4f} "
              f"validation_loss={val_loss:.4f}")

        if seq2seq:
            if config.decode == "beam":
                print("[translation] beam decode is decoder-only for now; "
                      "seq2seq uses greedy")
            gen_sents = generate_seq2seq(
                model, dataset["test"], src_key, tgt_key, tokenizer,
                config.model_max_length, desc)
        elif config.decode == "engine":
            gen_sents = generate_engine(
                model, dataset["test"], src_key, tgt_key, tokenizer,
                config.model_max_length, desc)
        else:
            gen_sents = generate(
                model, dataset["test"], src_key, tgt_key, tokenizer,
                config.model_max_length, desc,
                beam_size=(config.beam_size if config.decode == "beam"
                           else None))
        _dump({"generations": [
            {src_key: ex[src_key], tgt_key: ex[tgt_key], "gen": g}
            for ex, g in zip(dataset["test"], gen_sents)]},
            f"{workdir}/gen_epoch{epoch}.json", indent=2)
        eval_scores = evaluate_bleu(dataset["test"], gen_sents, tgt_key)
        results = {"epoch": epoch, "train_loss": train_loss,
                   "validation_loss": val_loss, **eval_scores}
        print(json.dumps(results))
        _dump(results, f"{workdir}/eval_results_epoch{epoch}.json")

        if config.save_checkpoints:
            from ..utils.checkpoint import save_checkpoint

            save_checkpoint(ckpt_dir, model, opt_state, step=epoch + 1)
    if loader is not None:
        loader.close()
    return results


def parse_args(argv=None) -> MTConfig:
    parser = argparse.ArgumentParser(description=__doc__)
    # fields whose default is None (type can't be inferred from the value)
    none_types = {"learning_rate": float, "workdir": str, "device": str}
    for f in dataclasses.fields(MTConfig):
        arg_type = (type(f.default) if f.default is not None
                    else none_types.get(f.name, str))
        if arg_type is bool:
            parser.add_argument(f"--{f.name.replace('_', '-')}",
                                type=lambda x: x.lower() in ("1", "true", "yes"),
                                default=f.default)
        else:
            parser.add_argument(f"--{f.name.replace('_', '-')}", type=arg_type,
                                default=f.default)
    return MTConfig(**vars(parser.parse_args(argv)))


if __name__ == "__main__":
    run(parse_args())
