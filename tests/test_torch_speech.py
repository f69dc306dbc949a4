"""zero_tpu_torch's speech translation against zero_tpu, fp32 on the CPU:
audio.py (the mel scale and filterbank, logmel, reading wav files,
loading features, CoLaCTC labels and SpeechDataset batches, with and
without context: exact, both are numpy); the CTC port against
optax.ctc_loss with grads (repeated labels, an infeasible row, an all-pad
row, coarse labels, padded frames); the AFS gates with the same noise
injected on both sides (JAX's sampler draws through jax.random.uniform,
the port's through l0norm.uniform_noise, each patched inside the tests);
then transformer_afs on weights bridged from the JAX init_fn, whose
temporal gates drop about half the frames: train_fn loss and grads in
modes tf (with st_context) and t, with CTC over coarse labels, with the
kernel flags off and on, and with one row's gates all closed; score_fn
and beam search at beam 4 and 1 with and without the eval compaction;
cache decode against dev mode; microbatch stacking of frames; a
checkpoint across the two packages; and the CLI on a speech manifest
(data_kind=speech in every mode)."""

import os
import wave
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import (NO_DROPOUT, check_checkpoint_round_trip,  # noqa: E402
                          check_score_fn, check_train_fn, port_config,
                          port_params, t)
from zero_tpu import audio as jaudio  # noqa: E402
from zero_tpu import evalu as jevalu  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.models import transformer_afs as jafs  # noqa: E402
from zero_tpu.ops.common import RngGen as JRngGen  # noqa: E402
from zero_tpu.saver import _flatten  # noqa: E402
from zero_tpu.search import beam_search as jbeam_search  # noqa: E402
from zero_tpu_torch import audio, evalu  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.models import transformer_afs as afs  # noqa: E402
from zero_tpu_torch.ops import ctc, l0norm  # noqa: E402
from zero_tpu_torch.ops.common import RngGen  # noqa: E402
from zero_tpu_torch.search import beam_search  # noqa: E402
from zero_tpu_torch.train_step import stack_microbatches  # noqa: E402

NAME = "transformer_afs"
MELS = 20
WORDS = ["w%d" % i for i in range(10)]
SIZE = dict(model_name=NAME, data_kind="speech", audio_num_mel_bins=MELS,
            audio_frame_stride=3, num_encoder_layer=1,
            num_st_encoder_layer=1, num_decoder_layer=1, ctc_enable=True,
            ctc_alpha=0.3, coarse_label_base=5, max_frame_len=64,
            afs_l0_scalar=0.5, l0_norm_end_reg_ramp_up=50)
STEP = 20        # inside the penalty's ramp


# ---------------------------------------------------------------------------
# audio.py
# ---------------------------------------------------------------------------

def _write_wav(path, samples, rate=16000, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(samples.astype(np.int16).tobytes())


def test_mel_scale_filterbank_and_logmel_match_jax():
    f = np.linspace(0.0, 8000.0, 33)
    np.testing.assert_array_equal(audio.hz_to_mel(f), jaudio.hz_to_mel(f))
    np.testing.assert_array_equal(audio.mel_to_hz(f), jaudio.mel_to_hz(f))
    for args in ((40, 512, 16000), (80, 512, 16000, 50.0, 7000.0)):
        np.testing.assert_array_equal(audio.mel_filterbank(*args),
                                      jaudio.mel_filterbank(*args))
    wav = np.random.RandomState(0).randn(16000).astype(np.float32)
    for mels in (80, 40):
        np.testing.assert_array_equal(audio.logmel(wav, 16000, mels),
                                      jaudio.logmel(wav, 16000, mels))
    # shorter than a frame: padded to one frame
    np.testing.assert_array_equal(audio.logmel(wav[:100]),
                                  jaudio.logmel(wav[:100]))


def test_read_wav_and_load_features_match_jax(tmp_path):
    rs = np.random.RandomState(1)
    _write_wav(tmp_path / "mono.wav", rs.randn(5000) * 3000)
    _write_wav(tmp_path / "stereo.wav", rs.randn(2, 4000).T * 3000,
               channels=2)
    np.save(tmp_path / "f.npy", rs.randn(13, MELS))
    for name in ("mono.wav", "stereo.wav"):
        path = str(tmp_path / name)
        got, want = audio.read_wav(path), jaudio.read_wav(path)
        assert got[1] == want[1] == 16000
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(audio.load_features(path, MELS),
                                      jaudio.load_features(path, MELS))
    path = str(tmp_path / "f.npy")
    got = audio.load_features(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jaudio.load_features(path))
    with pytest.raises(ValueError):
        audio.load_features(str(tmp_path / "x.flac"))


def test_coarse_labels_match_jax():
    ids = list(range(0, 60)) + [1, 2, 0, 17]
    for base in (1, 4, 7, 256):
        assert audio.coarse_labels(ids, base) == \
            jaudio.coarse_labels(ids, base)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """A vocabulary and a 10-utterance manifest: .npy features of 20-60
    frames (none a multiple of 3) and two 16 kHz .wav files, transcripts
    and translations of 2-6 words (relative paths)."""
    root = tmp_path_factory.mktemp("speech")
    rs = np.random.RandomState(0)
    (root / "vocab.txt").write_text("\n".join(WORDS) + "\n")
    lines = []
    for i in range(10):
        if i in (3, 7):
            name = "utt%d.wav" % i
            _write_wav(root / name, rs.randn(rs.randint(3000, 6000)) * 2000)
        else:
            name = "utt%d.npy" % i
            frames = 3 * rs.randint(7, 20) + rs.randint(1, 3)
            np.save(root / name, rs.randn(frames, MELS).astype(np.float32))
        transcript = " ".join(rs.choice(WORDS, rs.randint(2, 7)))
        translation = " ".join(rs.choice(WORDS, rs.randint(2, 7)))
        lines.append("%s\t%s\t%s" % (name, transcript, translation))
    (root / "train.tsv").write_text("\n".join(lines) + "\n")
    (root / "train.ref").write_text(
        "\n".join(line.split("\t")[2] for line in lines) + "\n")
    return root


def _vocab(root):
    from zero_tpu.vocab import Vocab as JVocab
    from zero_tpu_torch.vocab import Vocab
    path = str(root / "vocab.txt")
    return Vocab(path), JVocab(path)


def _batches(module, root, vocab, size, **kwargs):
    ds = module.SpeechDataset(str(root / "train.tsv"), vocab, vocab,
                              num_mels=MELS, **kwargs)
    return list(ds.batcher(size, buffer_size=64, shuffle=False, train=False))


@pytest.mark.parametrize("kind", ["batch", "token_context"])
def test_speech_dataset_batches_match_jax(manifest, kind):
    """Frame-budget bucketing (token) and row batches, transcripts folded
    into coarse labels, padded lengths each their own; with context, the
    first segment's all-zero context keeps an all-zero mask."""
    vocab, jvocab = _vocab(manifest)
    kwargs = dict(pad_seq_multiple=4, pad_batch_to=5, coarse_label_base=4)
    size = 4
    if kind == "token_context":
        kwargs.update(batch_or_token="token", context=True,
                      context_max_frame_len=16)
        size = 120
    else:
        kwargs.update(batch_or_token="batch")
    got = _batches(audio, manifest, vocab, size, **kwargs)
    want = _batches(jaudio, manifest, jvocab, size, **kwargs)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["index"] == w["index"] and len(g["raw"]) == len(w["raw"])
        for key in g:
            if key not in ("index", "raw"):
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
                assert g[key].dtype == w[key].dtype
        assert g["src"].shape[2] == MELS and g["src"].shape[0] == 5
    if kind == "token_context":
        first = [b for b in got if 0 in b["index"]][0]
        row = first["index"].index(0)
        assert not first["context"][row].any()
        assert not first["context_mask"][row].any()
        assert max(b["transcript"].max() for b in got) < 3 + 4


def test_stack_microbatches_pads_frames_and_transcripts(manifest):
    """[C, B, T, mels] float frames and transcripts padded to their own
    longest, each microbatch's values unchanged."""
    vocab, _ = _vocab(manifest)
    batches = _batches(audio, manifest, vocab, 3, batch_or_token="batch")[:2]
    feats = [{"audio": b["src"], "audio_mask": b["src_mask"],
              "target": b["tgt"], "transcript": b["transcript"]}
             for b in batches]
    # transcripts longer than the targets in one microbatch, shorter in
    # the other
    feats[0]["transcript"] = np.ones((3, 9), np.int32)
    feats[1]["transcript"] = np.ones((2, 1), np.int32)
    stacked = stack_microbatches(feats)
    for key in feats[0]:
        want = tuple(max(f[key].shape[d] for f in feats)
                     for d in range(feats[0][key].ndim))
        assert stacked[key].shape == (2,) + want
        assert stacked[key].dtype == feats[0][key].dtype
        for c, f in enumerate(feats):
            got = stacked[key][c][tuple(slice(0, n) for n in f[key].shape)]
            np.testing.assert_array_equal(got, f[key])
    assert stacked["audio"].shape[-1] == MELS


def test_a_speech_batch_fails_the_sample_decode_print_in_both_packages(
        manifest):
    """The training loop's sample print hands a speech batch's float
    frames to decode_target_token: a ValueError in both packages."""
    vocab, jvocab = _vocab(manifest)
    frames = _batches(audio, manifest, vocab, 4,
                      batch_or_token="batch")[0]["src"][0]
    with pytest.raises(ValueError):
        jevalu.decode_target_token(frames, jvocab)
    with pytest.raises(ValueError):
        evalu.decode_target_token(frames, vocab)


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

def _ctc_case(case):
    """Two rows: a feasible one with padded frames and ``case``'s row."""
    rs = np.random.RandomState(2)
    t_len, n_len, k = 9, 5, 8
    logits = (2.0 * rs.randn(2, t_len, k)).astype(np.float32)
    logit_pad = np.zeros((2, t_len), np.float32)
    logit_pad[0, 7:] = 1.0
    labels = np.zeros((2, n_len), np.int32)
    labels[0, :3] = [4, 1, 6]
    if case == "repeats":
        labels[1] = [3, 3, 5, 5, 5]
    elif case == "infeasible":      # 3 frames, 4 labels
        logit_pad[1, 3:] = 1.0
        labels[1, :4] = [3, 4, 5, 6]
    elif case == "all_pad":
        logit_pad[1] = 1.0
    elif case == "coarse":
        labels[1, :4] = audio.coarse_labels([9, 21, 4, 2], 5)
    label_pad = (labels == 0).astype(np.float32)
    return logits, logit_pad, labels, label_pad


def _optax(logits, logit_pad, labels, label_pad, dtype):
    """optax's per-row losses and the grads of their sum, in ``dtype``."""
    x = jnp.asarray(logits, dtype)
    pads = (jnp.asarray(logit_pad, dtype), jnp.asarray(label_pad, dtype))
    rows = optax.ctc_loss(x, pads[0], labels, pads[1])
    grad = jax.grad(lambda y: optax.ctc_loss(y, pads[0], labels,
                                             pads[1]).sum())(x)
    return np.asarray(rows), np.asarray(grad)


@pytest.mark.parametrize("case", ["repeats", "infeasible", "all_pad",
                                  "coarse"])
def test_ctc_loss_matches_optax_with_grads(case):
    """Losses within 1e-5 of optax's fp32 ones and grads within 1e-5 of
    optax's fp64 recursion, which the port computes (ops/ctc.py); on
    feasible rows the grads are within 1e-5 of optax's fp32 ones too. The
    infeasible row's fp32 grads are 2.7e-3 off optax's own fp64 ones (an
    fp32 ulp is 0.0078 at its -1e5 log-probabilities)."""
    logits, logit_pad, labels, label_pad = _ctc_case(case)
    rows32, grad32 = _optax(logits, logit_pad, labels, label_pad,
                            jnp.float32)
    with jax.enable_x64(True):
        rows64, grad64 = _optax(logits, logit_pad, labels, label_pad,
                                jnp.float64)
    x = t(logits).requires_grad_(True)
    got = ctc.ctc_loss(x, t(logit_pad), t(labels), t(label_pad))
    (grad,) = torch.autograd.grad(got.sum(), [x])
    assert got.dtype == torch.float32 and grad.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), rows32, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), rows64, rtol=1e-6,
                               atol=1e-6)
    scale = max(np.abs(grad64).max(), 1.0)
    assert np.abs(grad.numpy() - grad64).max() <= 1e-5 * scale
    feasible = [0] if case == "infeasible" else [0, 1]
    assert np.abs(grad.numpy()[feasible] - grad32[feasible]).max() \
        <= 1e-5 * scale
    assert np.isfinite(got.detach().numpy()).all()
    if case == "infeasible":
        assert got[1] > 1e5         # log_epsilon stands in for log 0
    if case == "all_pad":
        assert got[1] == 0.0 and not grad[1].any()


# ---------------------------------------------------------------------------
# the gates and the model
# ---------------------------------------------------------------------------

class Noise:
    """Uniform gate noise by shape from a numpy seed (the same whatever
    the order of the draws); ``closed_row`` zeroes that row of the
    temporal noise [B, T, 1], which closes every gate of the row."""

    def __init__(self, closed_row=None):
        self.closed_row = closed_row
        self.arrays = {}

    def __call__(self, shape):
        shape = tuple(int(n) for n in shape)
        if shape not in self.arrays:
            rs = np.random.RandomState(sum(shape) * 31 + len(shape))
            noise = rs.rand(*shape).astype(np.float32)
            if self.closed_row is not None and len(shape) == 3:
                noise[self.closed_row] = 0.0
            self.arrays[shape] = noise
        return self.arrays[shape]

    def patches(self):
        """Both packages' samplers draw this noise."""
        def jax_uniform(key, shape=(), dtype=jnp.float32, minval=0.0,
                        maxval=1.0):
            return jnp.asarray(self(shape), dtype)

        return (mock.patch.object(jax.random, "uniform", jax_uniform),
                mock.patch.object(l0norm, "uniform_noise",
                                  lambda words, shape, device:
                                  t(self(shape)).to(device)))


def _noise(noise):
    import contextlib
    stack = contextlib.ExitStack()
    for p in noise.patches():
        stack.enter_context(p)
    return stack


def _cfg(**over):
    return tiny_config(**{**SIZE, **NO_DROPOUT, **over})


def _jparams(cfg):
    """JAX weights whose temporal gates drop about half the frames."""
    params = jget_model(NAME).init_fn(jax.random.PRNGKey(0), cfg)
    params["afs_temporal"]["ws"][0] = params["afs_temporal"]["ws"][0] * 40
    params["afs_temporal"]["b"] = params["afs_temporal"]["b"] - 2.4
    return params


def _features(batch):
    feats = {"audio": batch["src"], "audio_mask": batch["src_mask"],
             "target": batch["tgt"], "transcript": batch["transcript"]}
    if "context" in batch:
        feats.update(context=batch["context"],
                     context_mask=batch["context_mask"])
    return feats


# (mode, st_context, closed row)
CASES = {"tf_context": ("tf", True, None), "t": ("t", False, None),
         "closed": ("tf", False, 0)}
SCORE_RATIO = {"tf_context": 0.3, "t": 0.0}


@pytest.fixture(scope="module")
def setup(manifest):
    """Batches of 5 rows (an all-pad one) from the manifest, with coarse
    transcripts and, for tf_context, the previous segment's frames; the
    JAX loss and grads of each case and the scores, in one jitted call."""
    vocab, jvocab = _vocab(manifest)
    batches = {}
    for context in (False, True):
        ds = audio.SpeechDataset(str(manifest / "train.tsv"), vocab, vocab,
                                 batch_or_token="batch", num_mels=MELS,
                                 pad_batch_to=5, coarse_label_base=5,
                                 context=context, context_max_frame_len=16)
        batches[context] = next(ds.batcher(4, buffer_size=64, shuffle=False,
                                           train=False))
    assert batches[False]["src"].shape[1] % 3    # the stride drops frames
    cases, jparams = {}, {}
    for name, (mode, context, closed) in CASES.items():
        cfg = _cfg(afs_mode=mode, st_context=context)
        cfg.src_vocab = cfg.tgt_vocab = jvocab
        if mode not in jparams:
            jparams[mode] = _jparams(cfg)
        cases[name] = dict(cfg=cfg, feats=_features(batches[context]),
                           noise=Noise(closed), jparams=jparams[mode])
    model = jget_model(NAME)
    current = {}

    def noise_of(shape):
        return current["noise"](shape)

    def all_cases(params):
        out = {}
        for name, c in cases.items():
            current["noise"] = c["noise"]
            jfeats = {k: jnp.asarray(v) for k, v in c["feats"].items()}
            loss, grads = jax.value_and_grad(
                lambda p: model.train_fn(p, jfeats, c["cfg"],
                                         jax.random.PRNGKey(1),
                                         step=STEP)["loss"])(
                params[c["cfg"].afs_mode])
            out[name] = {"loss": loss, "grads": grads}
            if name in SCORE_RATIO:
                scfg = _cfg(afs_mode=c["cfg"].afs_mode,
                            st_context=c["cfg"].st_context,
                            l0_compact_ratio=SCORE_RATIO[name])
                scfg.src_vocab = scfg.tgt_vocab = jvocab
                out[name]["score"] = model.score_fn(
                    params[scfg.afs_mode], jfeats, scfg)["score"]
        return out

    with mock.patch.object(
            jax.random, "uniform",
            lambda key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0:
            jnp.asarray(noise_of(shape), dtype)):
        want = jax.jit(all_cases)(jparams)
    for name, w in want.items():
        cases[name].update(loss=float(w["loss"]),
                           grads=_flatten(w["grads"], "params"))
        if "score" in w:
            cases[name]["score"] = np.asarray(w["score"])
    return dict(cases=cases, batches=batches, vocab=vocab, jvocab=jvocab)


@pytest.mark.parametrize("mode,training", [("tf", True), ("tf", False),
                                           ("t", True)])
def test_afs_gate_matches_jax(setup, mode, training):
    """Gated features, mask, penalty and keep_score on ASR outputs of the
    same values, the gates from the injected noise (training) or their
    mean (eval)."""
    case = setup["cases"]["tf_context" if mode == "tf" else "t"]
    cfg = case["cfg"]
    pcfg = port_config(cfg)
    params = port_params(NAME, case["jparams"], pcfg)
    rs = np.random.RandomState(6)
    x = (0.5 * rs.randn(5, 9, 16)).astype(np.float32)
    mask = np.ones((5, 9), np.float32)
    mask[1, 6:] = 0.0
    mask[4] = 0.0
    noise = Noise()
    with _noise(noise):
        want = jafs._afs_gate(case["jparams"], jnp.asarray(x),
                              jnp.asarray(mask), cfg,
                              JRngGen(jax.random.PRNGKey(2)), training)
        got = afs._afs_gate(params, t(x), t(mask), pcfg,
                            RngGen(torch.Generator().manual_seed(0)),
                            training)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    dropped = (got[0] == 0).all(dim=-1) & (t(mask) > 0)
    assert dropped.any() and (~dropped & (t(mask) > 0)).any()


@pytest.mark.parametrize("case,flag", [("tf_context", "off"),
                                       ("tf_context", "on"), ("t", "off"),
                                       ("closed", "on")])
def test_train_fn_and_grads_match_jax(setup, case, flag):
    """CE, the ramped AFS penalty and 0.3 x CTC over coarse labels. Flags
    on: every attention takes the fused kernel (plain version here; the
    context's ASR encoder too) and every FFN the fused one. ``closed``:
    row 0's temporal gates all close, so the ST encoder and the cross
    attention see a row with no valid key (finite, as JAX's)."""
    c = setup["cases"][case]
    on = flag == "on"
    with _noise(c["noise"]):
        launches = check_train_fn(NAME, c["cfg"], c["jparams"], c["feats"],
                                  c, step=STEP, use_flash_attention=on,
                                  use_fused_ffn=on)
    context = c["cfg"].st_context
    assert launches == ({"fused_attention_ref": 5 if context else 4,
                         "fused_ffn_ref": 4 if context else 3} if on else {})
    assert np.abs(c["grads"]["params/ctc_head/ws/0"]).max() > 0
    assert np.isfinite(c["loss"])
    if case == "closed":
        assert c["feats"]["audio_mask"][0].any()


@pytest.mark.parametrize("case", ["tf_context", "t"])
def test_score_fn_matches_jax(setup, case):
    """Mean gates; tf_context compacts 30% of the frames before the ST
    encoder and scores through the count softmax."""
    c = setup["cases"][case]
    cfg = _cfg(afs_mode=c["cfg"].afs_mode, st_context=c["cfg"].st_context,
               l0_compact_ratio=SCORE_RATIO[case])
    cfg.src_vocab = cfg.tgt_vocab = setup["jvocab"]
    check_score_fn(NAME, cfg, c["jparams"], c["feats"], c["score"])


def _source(feats):
    source = {"audio": feats["audio"], "mask": feats["audio_mask"]}
    if "context" in feats:
        source.update(context=feats["context"],
                      context_mask=feats["context_mask"])
    return source


def _port_beam(case, cfg, **overrides):
    pcfg = port_config(cfg, **overrides)
    source = {k: t(v) for k, v in _source(case["feats"]).items()}
    with torch.inference_mode():
        return beam_search(port_params(NAME, case["jparams"], pcfg), source,
                           get_model(NAME).infer_fn(pcfg), pcfg)


@pytest.mark.parametrize("case,beam,ratio", [("tf_context", 4, 0.3),
                                             ("tf_context", 1, 0.3),
                                             ("t", 4, 0.0)])
def test_beam_search_matches_jax(setup, case, beam, ratio):
    """The speech dict source: the length budget counts raw frames; at
    ratio 0.3 the compacted memory decodes through the count softmax."""
    c = setup["cases"][case]
    cfg = _cfg(afs_mode=c["cfg"].afs_mode, st_context=c["cfg"].st_context,
               l0_compact_ratio=ratio, beam_size=beam, decode_length=4,
               decode_max_len=80)
    cfg.src_vocab = cfg.tgt_vocab = setup["jvocab"]
    jsource = {k: jnp.asarray(v) for k, v in _source(c["feats"]).items()}
    want = jax.jit(lambda p, s: jbeam_search(
        p, s, jget_model(NAME).infer_fn(cfg), cfg))(c["jparams"], jsource)
    got = _port_beam(c, cfg)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]),
                               rtol=1e-4, atol=1e-4)
    # the budget: the longest row's raw frames + decode_length
    assert got["seq"].shape[2] == c["feats"]["audio"].shape[1] + 4
    assert got["steps"] > 0


@pytest.mark.parametrize("ratio", [0.0, 0.3])
def test_cache_decode_equals_dev_mode(setup, ratio):
    c = setup["cases"]["tf_context"]
    cfg = _cfg(st_context=True, l0_compact_ratio=ratio, beam_size=4,
               decode_length=4)
    cfg.src_vocab = cfg.tgt_vocab = setup["jvocab"]
    cache = _port_beam(c, cfg)
    dev = _port_beam(c, cfg, search_mode="dev")
    np.testing.assert_array_equal(dev["seq"].numpy(), cache["seq"].numpy())
    np.testing.assert_allclose(dev["score"].numpy(), cache["score"].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_checkpoint_round_trips_between_the_packages(setup, tmp_path):
    c = setup["cases"]["tf_context"]
    check_checkpoint_round_trip(NAME, c["cfg"], c["jparams"], str(tmp_path))


def test_cli_trains_serves_scores_and_ensembles_a_speech_manifest(
        manifest, tmp_path):
    """data_kind=speech through zero_tpu_torch.run on the CPU: 2 steps of
    2 microbatches (stacked frames, context on), --mode test at the
    compaction ratio, --mode score, --mode ensemble of the checkpoint
    with itself."""
    from zero_tpu_torch import run

    out = tmp_path / "out"
    files = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
             "src_test_file={0}/train.tsv,tgt_test_file={0}/train.ref,"
             "device=cpu,eval_batch_size=4".format(manifest))
    spec = (files + ",model_name=transformer_afs,data_kind=speech,"
            "hidden_size=16,embed_size=16,filter_size=32,num_heads=2,"
            "num_encoder_layer=1,num_st_encoder_layer=1,num_decoder_layer=1,"
            "audio_num_mel_bins=20,audio_frame_stride=3,ctc_enable=true,"
            "coarse_label_base=5,st_context=true,l0_compact_ratio=0.3,"
            "batch_or_token=batch,batch_size=4,update_cycle=2,beam_size=2,"
            "decode_length=4,decode_max_len=24,max_training_steps=2,"
            "disp_freq=1,save_freq=0,eval_freq=0,sample_freq=0,epoches=5,"
            "src_train_file={0}/train.tsv,tgt_train_file={0}/train.ref,"
            "output_dir={1}".format(manifest, out))
    summary = run.main(["--mode", "train", "--parameters", spec])
    assert summary["steps"] == 2
    assert all(np.isfinite(summary["losses"]))
    assert summary["shapes"][0][0][0][2] == MELS      # [B, T, mels] frames
    test = files + ",output_dir={0},test_output={0}/trans.txt".format(out)
    served = run.main(["--mode", "test", "--parameters", test])
    assert served["sentences"] == 10
    assert len((out / "trans.txt").read_text().splitlines()) == 10
    scores, ppl = run.main(["--mode", "score", "--parameters",
                            files + ",output_dir={0},test_output={0}/s.txt"
                            .format(out)])
    assert len(scores) == 10 and np.isfinite(scores).all() and ppl > 1
    both = run.main(["--mode", "ensemble", "--ensemble_dirs",
                     "{0};{0}".format(out), "--parameters",
                     files + ",test_output={0}/ens.txt".format(out)])
    assert both["sentences"] == 10
    assert (out / "ens.txt").read_text() == (out / "trans.txt").read_text()
    assert os.path.exists(out / "param.json")


def test_the_port_imports_no_optax():
    """The CTC loss is the port's own (ops/ctc.py)."""
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(root, "zero_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as r:
            tree = ast.parse(r.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [(path, n) for n in names
                    if n.split(".")[0] in ("optax", "jax", "zero_tpu")]
    assert len(files) > 15 and not bad, bad
