"""zero_tpu_torch CLI: ``--mode test`` on a checkpoint written by the JAX
package's Saver gives the JAX package's translations; device errors, and
modes and options of later slices; and the port's import boundary (no jax,
no zero_tpu)."""

import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from zero_tpu import evalu as jevalu  # noqa: E402
from zero_tpu.config import default_config  # noqa: E402
from zero_tpu.data import Dataset as JDataset  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.saver import Saver as JSaver  # noqa: E402
from zero_tpu.search import beam_search as jbeam_search  # noqa: E402
from zero_tpu.vocab import Vocab as JVocab  # noqa: E402
from zero_tpu_torch import run  # noqa: E402
from zero_tpu_torch.scripts.profile_decode import _busy_us  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ("model_name=transformer,hidden_size=16,embed_size=16,filter_size=32,"
         "num_heads=2,num_encoder_layer=2,num_decoder_layer=2,beam_size=3,"
         "decode_length=6,decode_max_len=24,eval_batch_size=8,"
         "pad_seq_multiple=4,shared_source_target_embedding=True")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rs = np.random.RandomState(3)
    words = ["tok%d" % i for i in range(14)]
    with open(d / "vocab.txt", "w") as w:
        w.write("\n".join(words) + "\n")
    lines = [" ".join(rs.choice(words, rs.randint(2, 9))) for _ in range(6)]
    for name in ("test.src", "test.tgt"):
        with open(d / name, "w") as w:
            w.write("\n".join(lines) + "\n")
    files = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
             "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
             "output_dir={0}/out".format(d))
    return d, SIZES + "," + files


def _jax_translations(d, spec):
    """JAX package: init params, save them with its Saver, beam-search the
    test batch, return the index-ordered top-beam lines."""
    cfg = default_config().parse(spec)
    cfg.src_vocab = JVocab(str(d / "vocab.txt"))
    cfg.tgt_vocab = cfg.src_vocab
    model = jget_model("transformer")
    params = model.init_fn(jax.random.PRNGKey(7), cfg)
    JSaver(output_dir=cfg.output_dir).save({"params": params}, step=1)
    data = JDataset(cfg.src_test_file, cfg.tgt_test_file, cfg.src_vocab,
                    cfg.tgt_vocab, max_len=cfg.eval_max_len,
                    pad_seq_multiple=cfg.pad_seq_multiple,
                    pad_batch_to=cfg.eval_batch_size, use_native=False)
    (batch,) = list(data.batcher(cfg.eval_batch_size, shuffle=False,
                                 train=False))
    out = jax.jit(lambda p, s: jbeam_search(p, s, model.infer_fn(cfg), cfg))(
        params, jnp.asarray(batch["src"]))
    n = len(batch["raw"])
    hypos, _ = jevalu.decode_hypothesis(np.asarray(out["seq"])[:n],
                                        np.asarray(out["score"])[:n], cfg)
    order = np.argsort(batch["index"])
    return [" ".join(hypos[i]) for i in order]


def test_mode_test_reads_jax_checkpoint_and_matches_jax(corpus):
    d, spec = corpus
    want = _jax_translations(d, spec)
    out_file = d / "trans.txt"
    summary = run.main(["--mode", "test", "--parameters",
                        spec + ",device=cpu,test_output=%s" % out_file])
    with open(out_file) as r:
        got = r.read().splitlines()
    assert got == want
    assert summary["sentences"] == 6 and summary["steps"] > 0


def test_device_cuda_without_a_card_raises(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--mode", "test", "--parameters",
                  corpus[1] + ",device=cuda"])


# --mode ensemble is a later slice; train and score are ported, but their
# options of a later slice (remat, scanned layers) raise before any work
_LATER = {"train": ["--parameters", "device=cpu,use_remat=true"],
          "score": ["--parameters", "device=cpu,scan_layers=true"],
          "ensemble": []}


@pytest.mark.parametrize("mode", ["train", "score", "ensemble"])
def test_modes_of_later_slices_raise(mode):
    with pytest.raises(NotImplementedError, match="slice"):
        run.main(["--mode", mode] + _LATER[mode])


def _imports(path):
    with open(path) as r:
        tree = ast.parse(r.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "zero_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "zero_tpu")]
    assert len(files) > 15 and not bad, bad


def test_profile_busy_time_is_the_union_of_kernel_intervals():
    """Overlapping and nested kernel intervals count once; gaps not."""
    assert _busy_us([(5.0, 9.0), (0.0, 2.0), (1.0, 3.0), (6.0, 7.0)]) == 7.0
    assert _busy_us([]) == 0.0
