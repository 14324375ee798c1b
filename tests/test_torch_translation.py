"""The port's machine-translation app against the JAX package's on the CPU:
data, tokenization and collation, the native loader, checkpoints, and
``run()`` end to end for both architectures.

``datasets.load_dataset`` is replaced by a function that raises, in both
packages, so the app takes its offline synthetic corpus and nothing here
reaches for the network.  ``run()`` uses ``tests/test_seq2seq.py``'s smoke
config (vocab 300, E 64, 4 heads, 1 layer, 24 tokens, 6 steps of 32, no
dropout, Python collate, no checkpoints); the port's model gets the JAX
app's initial weights through ``load_jax_params``; one JAX run and one
port run per arch are shared by the module.  Tolerances: train losses
step by step and the validation loss within 1e-4 relative; f32 greedy
generations identical, so BLEU is equal; data, token arrays and loader
batches identical; a restored checkpoint resumes to bit-identical losses.
"""

import ctypes
import json
import os

import jax
import numpy as np
import pytest
import torch

import flashattn_tpu as ft
import flashattn_tpu_torch as pt
from flashattn_tpu.training import deen_fixture as jfix
from flashattn_tpu.training import translation as jtr
from flashattn_tpu.utils import native_loader as jnl
from flashattn_tpu_torch.training import deen_fixture as tfix
from flashattn_tpu_torch.training import translation as ttr
from flashattn_tpu_torch.utils import checkpoint as tck
from flashattn_tpu_torch.utils import native_loader as tnl

torch.set_num_threads(1)

SMOKE = dict(n_epochs=1, samples_per_epoch=192, batch_size=32, n_vocab=300,
             n_embd=64, n_head=4, n_layer=1, model_max_length=24,
             synthetic_size=400, save_checkpoints=False,
             use_native_loader=False, p_dropout=0.0, steps_per_dispatch=4)


def _offline(mp):
    """``datasets.load_dataset`` raises, so both apps fall back to the
    synthetic corpus without a download attempt."""
    import datasets

    def load_dataset(*args, **kwargs):
        raise ConnectionError("dataset downloads are disabled in this test")

    mp.setattr(datasets, "load_dataset", load_dataset)


def _jax_twin(config, seq2seq):
    """The JAX app's initial model for ``config`` (its run() builds it from
    PRNGKey(config.seed))."""
    kw = dict(n_vocab=config.n_vocab, n_embd=config.n_embd,
              n_head=config.n_head, n_positions=config.model_max_length,
              p_dropout=config.p_dropout, attn_impl=config.attn_impl,
              use_fused_layernorm=config.use_fused_layernorm,
              remat=config.remat, key=jax.random.PRNGKey(config.seed))
    if seq2seq:
        return ft.EncoderDecoderLM(n_encoder_layer=config.n_layer,
                                   n_decoder_layer=config.n_layer, **kw)
    return ft.DecoderLM(n_layer=config.n_layer, **kw)


def _recording(module, mp):
    """Record every train step's loss that ``module``'s run() takes."""
    losses = []
    orig = module._dispatch_chunk

    def dispatch(*args):
        out = orig(*args)
        losses.extend(np.asarray(out[3]).tolist())
        return out

    mp.setattr(module, "_dispatch_chunk", dispatch)
    return losses


def _run_both(arch, tmp):
    with pytest.MonkeyPatch.context() as mp:
        _offline(mp)
        j_losses = _recording(jtr, mp)
        t_losses = _recording(ttr, mp)
        build = ttr._build_model

        def build_from_jax(config, seq2seq, device):
            tm = build(config, seq2seq, device)
            jm = _jax_twin(config, seq2seq)
            return pt.load_jax_params(
                tm, {n: np.asarray(a) for n, a in jm.named_parameters()})

        mp.setattr(ttr, "_build_model", build_from_jax)
        jdir, tdir = str(tmp / "jax"), str(tmp / "port")
        want = jtr.run(jtr.MTConfig(arch=arch, workdir=jdir, **SMOKE))
        got = ttr.run(ttr.MTConfig(arch=arch, workdir=tdir, device="cpu",
                                   **SMOKE))
    gens = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "gen_epoch0.json")) as f:
            gens.append([g["gen"] for g in json.load(f)["generations"]])
    return dict(want=want, got=got, j_losses=j_losses, t_losses=t_losses,
                j_gen=gens[0], t_gen=gens[1])


@pytest.fixture(scope="module", params=["seq2seq", "decoder_only"])
def runs(request, tmp_path_factory):
    return _run_both(request.param, tmp_path_factory.mktemp(request.param))


def test_run_matches_jax(runs):
    """Per-step train losses and the validation loss within 1e-4 relative,
    generations identical, BLEU equal."""
    want, got = runs["want"], runs["got"]
    assert len(runs["t_losses"]) == len(runs["j_losses"]) == 6
    np.testing.assert_allclose(runs["t_losses"], runs["j_losses"], rtol=1e-4)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["validation_loss"],
                               want["validation_loss"], rtol=1e-4)
    assert runs["t_gen"] == runs["j_gen"]
    assert len(runs["t_gen"]) == 100
    assert got["bleu"] == want["bleu"]
    assert got["epoch"] == want["epoch"] == 0


# -- data ----------------------------------------------------------------------


def test_fixture_and_splits_match_jax(monkeypatch):
    """The port's copy of the vendored corpus and its splits, the synthetic
    corpus and the offline fallback's splits equal JAX's."""
    assert tfix.make_fixture_dataset(11111) == jfix.make_fixture_dataset(11111)
    assert tfix.make_fixture_dataset(0) != tfix.make_fixture_dataset(1)
    assert (ttr.get_dataset("deen-fixture", 40, seed=3)
            == jtr.get_dataset("deen-fixture", 40, seed=3))
    assert (ttr.make_synthetic_dataset(300, 7)
            == jtr.make_synthetic_dataset(300, 7))
    _offline(monkeypatch)
    got = ttr.get_dataset("an/unreachable-dataset", 24, 400, 11111)
    assert got == jtr.get_dataset("an/unreachable-dataset", 24, 400, 11111)
    assert len(got[0]["test"]) == 100


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The synthetic corpus and a tokenizer trained once by the port's
    get_tokenizer (JAX's trains the same vocabulary)."""
    examples = ttr.make_synthetic_dataset(400, 11111)
    tdir = tmp_path_factory.mktemp("tok_port")
    jdir = tmp_path_factory.mktemp("tok_jax")
    tok = ttr.get_tokenizer(examples, 300, "de", "en", str(tdir))
    jtok = jtr.get_tokenizer(examples, 300, "de", "en", str(jdir))
    assert tok.vocab == jtok.vocab
    return examples, tok


def test_collate_and_tokenize_match_jax(corpus):
    examples, tok = corpus
    for name in ("collate_batch", "collate_batch_seq2seq"):
        got = getattr(ttr, name)(examples[:37], "de", "en", tok, 24)
        want = getattr(jtr, name)(examples[:37], "de", "en", tok, 24)
        assert set(got) == set(want), name
        for k in want:
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=name + k)
    assert (ttr.tokenize_corpus(examples, tok, "de", "en")
            == jtr.tokenize_corpus(examples, tok, "de", "en"))


def test_native_loader_matches_jax(corpus):
    """``NativeDataLoader`` batches equal the JAX loader's at the same seed,
    across an epoch boundary; the library also builds from source into the
    port's build directory (never under native/)."""
    examples, tok = corpus
    data = ttr.tokenize_corpus(examples, tok, "de", "en")
    pad = tok.vocab["<pad>"]
    loaders = [mod.NativeDataLoader(data, pad, 24, 64, seed=11111)
               for mod in (tnl, jnl)]
    try:
        for _ in range(8):                     # 512 rows over 400 examples
            got, want = (ld.next_batch() for ld in loaders)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        for ld in loaders:
            ld.close()
    assert got["input_ids"].shape == (64, 23)
    path = tnl.build_native(force=True)
    assert os.path.dirname(path) == str(tnl._BUILD_DIR)
    assert ctypes.CDLL(path).loader_create


# -- checkpoints ---------------------------------------------------------------


def _ckpt_setup(seed):
    model = pt.EncoderDecoderLM(60, 64, 2, 16, p_dropout=0.0,
                                n_encoder_layer=1, n_decoder_layer=1,
                                middle_dim=64, device="cpu",
                                generator=torch.Generator().manual_seed(seed))
    opt = pt.Adam(lr=pt.warmup_cosine(2e-3, 2, 10))
    return model, opt, opt.init(model)


def _ckpt_batches(n):
    rng = np.random.default_rng(12)
    tokens = {"src": torch.from_numpy(rng.integers(3, 60, (n, 4, 9))),
              "src_lens": torch.from_numpy(rng.integers(1, 10, (n, 4))),
              "tgt_in": torch.from_numpy(rng.integers(3, 60, (n, 4, 7)))}
    labels = torch.from_numpy(rng.integers(3, 60, (n, 4, 7)))
    mask = torch.ones(n, 4, 7)
    return tokens, labels, mask


@pytest.mark.parametrize("asynchronous", [False, True],
                         ids=["sync", "async"])
def test_checkpoint_round_trip_resumes(tmp_path, asynchronous):
    """Two steps, a checkpoint, two more steps; a fresh model and optimizer
    state restored from the checkpoint take the same two steps to
    bit-identical losses and parameters."""
    tokens, labels, mask = _ckpt_batches(4)
    head = ({k: v[:2] for k, v in tokens.items()}, labels[:2], mask[:2])
    tail = ({k: v[2:] for k, v in tokens.items()}, labels[2:], mask[2:])
    model, opt, state = _ckpt_setup(0)
    scan = pt.make_train_scan(opt, ttr.seq2seq_loss, grad_clip=1.0)
    model, state, _ = scan(model, state, *head)
    path = str(tmp_path / "ckpt")
    if asynchronous:
        manager = tck.AsyncCheckpointManager()
        manager.save(path, model, state, step=2)
        manager.close()
    else:
        tck.save_checkpoint(path, model, state, step=2)
    assert os.listdir(path) == ["checkpoint.pt"]
    model, state, want = scan(model, state, *tail)

    fresh, opt2, template = _ckpt_setup(1)
    fresh, restored, step = tck.restore_checkpoint(path, fresh, template)
    assert step == 2 and type(restored) is type(template)
    assert restored.step == 2
    scan2 = pt.make_train_scan(opt2, ttr.seq2seq_loss, grad_clip=1.0)
    fresh, restored, got = scan2(fresh, restored, *tail)
    assert torch.equal(got, want)
    for (name, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), name


# -- generation and the command line -------------------------------------------


class _Tok:
    """Minimal tokenizer double over integer 'words'."""

    def __init__(self):
        self.vocab = {"<pad>": 0, "<eos_de>": 1, "<eos_en>": 2}

    def __call__(self, text):
        ids = []
        for w in text.replace("<eos_de>", " <eos_de> ").split():
            ids.append(self.vocab.setdefault(w, len(self.vocab)))
        return {"input_ids": ids}

    def decode(self, ids):
        inv = {v: k for k, v in self.vocab.items()}
        return " ".join(inv.get(i, "?") for i in ids)


def test_generate_engine_matches_generate():
    """``tests/test_generate.py::test_generate_engine_matches_generate`` on
    the port: the engine path (paged pools, prompt lookup) gives the
    sentences of the batched cached greedy path, and the model keeps its
    train mode."""
    model = pt.DecoderLM(64, 32, 4, 48, p_dropout=0.0, n_layer=2,
                         device="cpu",
                         generator=torch.Generator().manual_seed(7))
    examples = [{"de": "w3 w4 w5", "en": ""}, {"de": "w6 w7", "en": ""},
                {"de": "w3 w4 w3 w4 w3", "en": ""}]
    tok = _Tok()
    base = ttr.generate(model, examples, "de", "en", tok, 16)
    eng = ttr.generate_engine(model, examples, "de", "en", tok, 16,
                              max_batch=2)
    assert eng == base, (eng, base)
    assert model.training


def test_generate_engine_past_position_table_matches_jax(capsys):
    """C14: the app's decoder-only model has ``n_positions ==
    model_max_length`` and its engine serves up to twice that, so rows run
    past the position table; there JAX's ``jnp.take`` gives NaN logits
    (token 0) and NaN K/V rows in the pages, which a later request's page
    walk meets again.  The port's engine gives JAX's engine's sentences and
    prompt-lookup acceptance on the same weights."""
    jm = ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=2,
                      key=jax.random.PRNGKey(7))
    tm = pt.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=2, device="cpu")
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    examples = [{"de": "w3 w4 w5", "en": ""}, {"de": "w6 w7", "en": ""},
                {"de": "w3 w4 w3 w4 w3", "en": ""}]
    outs = []
    for module, model in ((jtr, jm), (ttr, tm)):
        sents = module.generate_engine(model, examples, "de", "en", _Tok(), 16,
                                       max_batch=2)
        stats = capsys.readouterr().out
        outs.append((sents, stats[stats.index("lookup_acceptance"):].split(",")[0]))
    assert outs[1] == outs[0], outs
    assert outs[0][1] == "lookup_acceptance': 1.875"


def test_parse_args_matches_jax():
    """The same flags and defaults as the JAX app, plus ``--device``."""
    got = ttr.parse_args(["--arch", "seq2seq", "--dataset-name",
                          "deen-fixture", "--device", "cpu", "--remat", "1"])
    want = jtr.parse_args(["--arch", "seq2seq", "--dataset-name",
                           "deen-fixture", "--remat", "1"])
    g = dict(vars(got))
    assert g.pop("device") == "cpu"
    assert g == vars(want)
    assert ttr.parse_args([]).device is None
