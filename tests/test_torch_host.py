"""zero_tpu_torch's host side against zero_tpu on the CPU: the native C++
tokeniser (built with g++ into the package's _build/) gives the JAX
package's native ids and the python path's, and falls back as it does;
``process_num`` forked workers give the serial path's batches, and
train.py passes ``process_num`` and ``native_tokenizer`` to the dataset;
every metric and the metric CLI give the JAX package's values and output
(the Perl golden detokenized BLEU included); each ported script gives the
JAX script's output on the same inputs and seed."""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from test_metric import _DETOK_HYP, _DETOK_REF0, _DETOK_REF1  # noqa: E402
from zero_tpu import metric as jmetric  # noqa: E402
from zero_tpu import native as jnative  # noqa: E402
from zero_tpu.data import Dataset as JDataset  # noqa: E402
from zero_tpu.saver import (_write_index as j_write_index,  # noqa: E402
                            save_checkpoint_file as j_save)
from zero_tpu.scripts import bleu_over_length as jbol  # noqa: E402
from zero_tpu.scripts import checkpoint_averaging as javg  # noqa: E402
from zero_tpu.scripts import chrf as jchrf  # noqa: E402
from zero_tpu.scripts import (  # noqa: E402
    evaluate_pos_translation_rate as jpos)
from zero_tpu.scripts import make_synth_mt as jsynth  # noqa: E402
from zero_tpu.scripts import shuffle_corpus as jshuf  # noqa: E402
from zero_tpu.vocab import Vocab as JVocab  # noqa: E402
from zero_tpu_torch import metric, native, run, train  # noqa: E402
from zero_tpu_torch.config import default_config  # noqa: E402
from zero_tpu_torch.data import Dataset  # noqa: E402
from zero_tpu_torch.saver import load_checkpoint_file  # noqa: E402
from zero_tpu_torch.scripts import (bleu_over_length, chrf,  # noqa: E402
                                    checkpoint_averaging,
                                    evaluate_pos_translation_rate,
                                    make_synth_mt, shuffle_corpus)
from zero_tpu_torch.vocab import Vocab  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# native tokeniser and forked workers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Unicode words and whitespace (NBSP, thin and ideographic spaces),
    a blank side, a truncated line, OOV words, tabs, CRLF line ends and a
    last line without a newline; then 300 random pairs."""
    d = tmp_path_factory.mktemp("host")
    words = ["hello", "wörld", "日本語", "a", "b", "zz"]
    with open(d / "vocab.txt", "w") as w:
        w.write("<pad>\n<unk>\n<eos>\n" + "\n".join(words) + "\n")
    src = ["hello wörld 日本語", "a b hello", "   ",
           "a b a b a b a b a b", "OOV hello a", "b  a\tb",
           "　zz　"]
    tgt = ["a b", "hello", "zz", "b a", "日本語", "a", "b"]
    rs = np.random.RandomState(0)
    for _ in range(300):
        src.append(" ".join(rs.choice(words + ["oov"], rs.randint(1, 12))))
        tgt.append(" ".join(rs.choice(words, rs.randint(1, 12))))
    with open(d / "c.src", "w", newline="") as w:
        w.write("\r\n".join(src))
    with open(d / "c.tgt", "w") as w:
        w.write("\n".join(tgt) + "\n")
    return str(d / "c.src"), str(d / "c.tgt"), str(d / "vocab.txt")


def _ids(pairs):
    return [(list(np.asarray(s)), list(np.asarray(t))) for s, t in pairs]


def test_native_ids_equal_jax_native_and_the_python_path(corpus):
    src, tgt, vocab_file = corpus
    v = Vocab(vocab_file)
    python = list(Dataset(src, tgt, v, v, max_len=6,
                          use_native=False)._tokenize_serial())
    before = native.calls["encode_corpus"]
    got = native.encode_corpus(src, tgt, vocab_file, vocab_file, 6,
                               n_threads=2)
    assert native.calls["encode_corpus"] == before + 1
    want = jnative.encode_corpus(src, tgt, vocab_file, vocab_file, 6)
    assert got is not None and want is not None
    assert _ids(got) == _ids(want) == _ids(python)
    assert len(python) == 306          # one pair skipped (a blank side)
    assert all(s.dtype == np.int32 for s, _ in got)
    # built into the package's git-ignored build directory
    lib = native._load()
    assert os.path.dirname(lib._name) == os.path.join(REPO, "zero_tpu_torch",
                                                      "_build")


def test_native_falls_back_as_the_jax_package(tmp_path, corpus):
    """Invalid UTF-8 and a missing file: None from both libraries (not
    counted), and the Dataset's python path then raises as the JAX
    package's does."""
    _, _, vocab_file = corpus
    bad = tmp_path / "bad.src"
    bad.write_bytes(b"a \xff\xfe b\n")
    good = tmp_path / "good.tgt"
    good.write_text("b a\n")
    before = native.calls["encode_corpus"]
    for lib in (native, jnative):
        assert lib.encode_corpus(str(bad), str(good), vocab_file, vocab_file,
                                 8) is None
        assert lib.encode_corpus(str(tmp_path / "none"), str(good),
                                 vocab_file, vocab_file, 8) is None
    assert native.calls["encode_corpus"] == before
    v, jv = Vocab(vocab_file), JVocab(vocab_file)
    errors = []
    for cls, vocab in ((Dataset, v), (JDataset, jv)):
        ds = cls(str(bad), str(good), vocab, vocab, max_len=8,
                 vocab_files=(vocab_file, vocab_file), use_native=True)
        with pytest.raises(UnicodeDecodeError) as err:
            list(ds.load_data())
        errors.append(type(err.value))
    assert errors[0] is errors[1]


def _batches(ds, size=40):
    np.random.seed(5)
    return [(b["src"].tolist(), b["tgt"].tolist(), list(b["index"]))
            for b in ds.batcher(size, buffer_size=64, shuffle=True,
                                train=True)]


@pytest.mark.parametrize("batch_or_token", ["batch", "token"])
def test_process_num_batches_equal_the_serial_and_native_ones(
        corpus, batch_or_token):
    """Two forked workers, the serial path and the native path give the
    same batches in the same order (and JAX's forked path too)."""
    src, tgt, vocab_file = corpus
    v = Vocab(vocab_file)
    size = 8 if batch_or_token == "batch" else 40

    def make(cls, vocab, workers, use_native):
        return cls(src, tgt, vocab, vocab, max_len=6,
                   batch_or_token=batch_or_token, num_workers=workers,
                   vocab_files=(vocab_file, vocab_file),
                   use_native=use_native)

    serial = _batches(make(Dataset, v, 0, False), size)
    forked = make(Dataset, v, 2, False)

    def no_serial():
        raise AssertionError("the forked dataset tokenised serially")
    forked._tokenize_serial = no_serial
    assert _batches(forked, size) == serial
    assert _batches(make(Dataset, v, 2, True), size) == serial
    jv = JVocab(vocab_file)
    assert _batches(make(JDataset, jv, 2, False), size) == serial
    assert len(serial) > 3


def test_train_passes_process_num_and_native_tokenizer(corpus):
    """The training set takes process_num workers and the native flag; an
    eval set no workers (the JAX package's train.py:_make_dataset)."""
    src, tgt, vocab_file = corpus
    params = default_config().parse(
        "process_num=3,native_tokenizer=false,src_vocab_file=%s,"
        "tgt_vocab_file=%s" % (vocab_file, vocab_file))
    params.src_vocab = params.tgt_vocab = Vocab(vocab_file)
    ds = train._make_dataset(params, src, tgt, train=True)
    assert (ds.num_workers, ds.use_native, ds.vocab_files) == (
        3, False, (vocab_file, vocab_file))
    ev = train._make_dataset(params, src, tgt)
    assert ev.num_workers == 0


def test_cli_training_with_process_num_and_native_matches_serial(tmp_path):
    """--mode train of a tiny transformer three ways: python serial,
    process_num=2 forked workers, the native tokeniser (whose counter
    shows it ran): the same losses step for step."""
    rs = np.random.RandomState(4)
    words = ["tok%d" % i for i in range(12)]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    lines = [" ".join(rs.choice(words, rs.randint(2, 9))) for _ in range(64)]
    for side in ("src", "tgt"):
        (tmp_path / ("train." + side)).write_text("\n".join(lines) + "\n")
    spec = ("device=cpu,hidden_size=16,embed_size=16,filter_size=32,"
            "num_heads=2,num_encoder_layer=1,num_decoder_layer=1,"
            "batch_or_token=batch,batch_size=16,max_training_steps=3,"
            "disp_freq=1,eval_freq=0,save_freq=0,sample_freq=0,"
            "src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_train_file={0}/train.src,tgt_train_file={0}/train.tgt"
            .format(tmp_path))
    losses = {}
    for label, extra in (("serial", "process_num=0,native_tokenizer=false"),
                         ("forked", "process_num=2,native_tokenizer=false"),
                         ("native", "process_num=0,native_tokenizer=true")):
        before = native.calls["encode_corpus"]
        summary = run.main(["--mode", "train", "--parameters",
                            "%s,%s,output_dir=%s/%s" % (spec, extra, tmp_path,
                                                        label)])
        ran = native.calls["encode_corpus"] - before
        assert ran == (1 if label == "native" else 0), (label, ran)
        losses[label] = summary["losses"]
    assert losses["serial"] == losses["forked"] == losses["native"]
    assert len(losses["serial"]) == 3


# ---------------------------------------------------------------------------
# metrics and the metric CLI
# ---------------------------------------------------------------------------

def _random_corpus(seed, n=30, refs=2):
    rs = np.random.RandomState(seed)
    words = ["w%d" % i for i in range(15)] + [",", ".", "'s", "-"]

    def line():
        return " ".join(rs.choice(words, rs.randint(1, 14)))
    cand = [line() for _ in range(n)]
    ref = [tuple(line() for _ in range(refs)) for _ in range(n)]
    return cand, ref


@pytest.mark.parametrize("name", ["bleu", "otem", "utem"])
@pytest.mark.parametrize("bp", ["closest", "shortest"])
def test_token_metrics_equal_jax(name, bp):
    cand, ref = _random_corpus(1)
    c = [x.split() for x in cand]
    r = [[x.split() for x in rs] for rs in ref]
    for smooth in (False, True):
        for n in (2, 4):
            got = getattr(metric, name)(c, r, bp=bp, smooth=smooth, n=n)
            want = getattr(jmetric, name)(c, r, bp=bp, smooth=smooth, n=n)
            assert got == want


def test_detok_bleu_chrf_and_v13a_equal_jax():
    """detok BLEU on the Perl golden data (multi-bleu-detok.perl: BLEU =
    81.75), lowercased too; chrF at two betas; v13a on punctuation,
    entities and digits."""
    refs = list(zip(_DETOK_REF0, _DETOK_REF1))
    got = metric.detok_bleu(_DETOK_HYP, refs)
    assert got == jmetric.detok_bleu(_DETOK_HYP, refs)
    assert abs(got - 0.8175383049272444) < 1e-9
    assert metric.detok_bleu(_DETOK_HYP, refs, lowercase=True) == \
        jmetric.detok_bleu(_DETOK_HYP, refs, lowercase=True)
    cand, ref = _random_corpus(2, refs=1)
    ref = [r[0] for r in ref]
    for beta in (1.0, 3.0):
        assert metric.chrf(cand, ref, beta=beta) == \
            jmetric.chrf(cand, ref, beta=beta)
    for line in ("The U.S. costs $1,234.56, right?",
                 "A&amp;B &lt;t&gt; &quot;q&quot; <skipped> x",
                 "2-jährige pre-war e.g. 3.5"):
        assert metric.v13a_tokenize(line) == jmetric.v13a_tokenize(line)


def _main_output(module_main, argv, capsys):
    saved = sys.argv
    sys.argv = argv
    try:
        module_main()
    finally:
        sys.argv = saved
    return capsys.readouterr().out


@pytest.mark.parametrize("flags", [[], ["--detok"], ["-lc", "-bp",
                                                      "shortest"]])
def test_metric_cli_prints_what_the_jax_cli_prints(tmp_path, capsys, flags):
    """Two references as ref0/ref1 (the CLI's numbered-reference rule)."""
    (tmp_path / "hyp").write_text("\n".join(_DETOK_HYP) + "\n")
    (tmp_path / "ref0").write_text("\n".join(_DETOK_REF0) + "\n")
    (tmp_path / "ref1").write_text("\n".join(_DETOK_REF1) + "\n")
    argv = ["metric"] + flags + [str(tmp_path / "hyp"), str(tmp_path / "ref")]
    got = _main_output(metric.main, argv, capsys)
    want = _main_output(jmetric.main, argv, capsys)
    assert got == want and got.strip()


# ---------------------------------------------------------------------------
# scripts
# ---------------------------------------------------------------------------

def test_checkpoint_averaging_equals_the_jax_script(tmp_path):
    d = tmp_path / "train"
    rs = np.random.RandomState(6)
    names = []
    for i in range(4):
        tree = {"w": rs.randn(4, 3).astype(np.float32),
                "nested": {"b": rs.randn(2).astype(np.float32)}}
        j_save(str(d), "model-%d" % i, {"params": tree, "opt": tree})
        names.append("model-%d" % i)
    j_write_index(str(d), names)
    (d / "param.json").write_text('{"hidden_size": 4}')
    got = checkpoint_averaging.average_checkpoints(str(d), str(tmp_path / "p"),
                                                   checkpoints=3)
    want = javg.average_checkpoints(str(d), str(tmp_path / "j"),
                                    checkpoints=3)
    a, b = load_checkpoint_file(got), load_checkpoint_file(want)
    assert sorted(a) == sorted(b) == ["params/nested/b", "params/w"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for out in ("p", "j"):
        assert (tmp_path / out / "param.json").read_text() == \
            '{"hidden_size": 4}'
        assert (tmp_path / out / "checkpoint").read_text() == \
            (tmp_path / "j" / "checkpoint").read_text()


def _text_files(tmp_path, cand, refs):
    (tmp_path / "hyp").write_text("\n".join(cand) + "\n")
    for i, r in enumerate(refs):
        (tmp_path / ("ref%d" % i)).write_text("\n".join(r) + "\n")


def test_chrf_and_bleu_over_length_scripts_equal_jax(tmp_path, capsys):
    cand, ref = _random_corpus(3)
    refs = list(zip(*ref))
    _text_files(tmp_path, cand, refs)
    (tmp_path / "src").write_text("\n".join(reversed(cand)) + "\n")
    argv = ["chrf", "-H", str(tmp_path / "hyp"), "-R", str(tmp_path / "ref0"),
            "-b", "2"]
    got = _main_output(chrf.main, argv, capsys)
    assert got == _main_output(jchrf.main, argv, capsys) and "chrF2" in got
    argv = ["bol", "-g", "3", "-source", str(tmp_path / "src"), "-candidate",
            str(tmp_path / "hyp"), "-reference", str(tmp_path / "ref0"),
            str(tmp_path / "ref1")]
    got = _main_output(bleu_over_length.main, argv, capsys)
    assert got == _main_output(jbol.main, argv, capsys)
    assert "Group Idx 2" in got


def test_shuffle_corpus_equals_the_jax_script(tmp_path):
    for name in ("a", "b"):
        (tmp_path / name).write_text("".join("%s%d\n" % (name, i)
                                             for i in range(25)))
    files = [str(tmp_path / "a"), str(tmp_path / "b")]
    got = shuffle_corpus.shuffle_corpus(files, "p", seed=11)
    want = jshuf.shuffle_corpus(files, "j", seed=11)
    for g, w in zip(got, want):
        assert open(g).read() == open(w).read()
    assert open(got[0]).read() != open(files[0]).read()


def test_make_synth_mt_equals_the_jax_script(tmp_path):
    make_synth_mt.generate(str(tmp_path / "p"), 40, 5, 5, 300, seed=3)
    jsynth.generate(str(tmp_path / "j"), 40, 5, 5, 300, seed=3)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names and len(names) == 8
    for name in names:
        assert (tmp_path / "p" / name).read_text() == \
            (tmp_path / "j" / name).read_text()


def test_pos_translation_rate_equals_the_jax_script(tmp_path, capsys):
    rs = np.random.RandomState(8)
    tagged = ["cat_NN", "runs_VBZ", "red_JJ", "fast_RB", "dog_NN", "ate_VBD",
              "the_DT"]

    def line():
        return " ".join(rs.choice(tagged, rs.randint(2, 10)))
    (tmp_path / "trans").write_text("\n".join(line() for _ in range(20)))
    for i in range(2):
        (tmp_path / ("ref%d" % i)).write_text(
            "\n".join(line() for _ in range(20)))
    argv = ["pos", "--trans", str(tmp_path / "trans"), "--ngram", "3",
            "--refs", str(tmp_path / "ref0"), str(tmp_path / "ref1")]
    got = _main_output(evaluate_pos_translation_rate.main, argv, capsys)
    assert got == _main_output(jpos.main, argv, capsys)
    assert got.count("Pos:") == 18
