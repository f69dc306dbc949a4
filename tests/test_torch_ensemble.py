"""zero_tpu_torch ensemble decoding against zero_tpu's, fp32 on the CPU:
``make_ensemble_inference`` over a transformer and a transformer_rela on
weights bridged from the JAX init functions decodes JAX's sequences with
its scores (and the same in dev mode), and ``--mode ensemble`` reads the
two checkpoints the JAX package saved and writes the translations
``zero_tpu.run --mode ensemble`` writes."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from helpers import tiny_config  # noqa: E402
from torch_parity import bridge, port_config, t  # noqa: E402
from zero_tpu import run as jrun  # noqa: E402
from zero_tpu import train as jtrain  # noqa: E402
from zero_tpu.config import default_config, save_parameters  # noqa: E402
from zero_tpu.models import get_model as jget_model  # noqa: E402
from zero_tpu.saver import Saver as JSaver  # noqa: E402
from zero_tpu.search import beam_search as jbeam_search  # noqa: E402
from zero_tpu.vocab import Vocab as JVocab  # noqa: E402
from zero_tpu_torch import run  # noqa: E402
from zero_tpu_torch import train  # noqa: E402
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.ops.kernels import decode_attention as da  # noqa: E402
from zero_tpu_torch.search import beam_search  # noqa: E402

NAMES = ("transformer", "transformer_rela")
SIZE = dict(num_encoder_layer=1, num_decoder_layer=1)


def test_ensemble_inference_matches_jax():
    """Beam 3: each model keeps its own cache mode (ancestry pools on the
    CPU; ReLA's pool steps in relu mode), the step's log-probabilities are
    the log of the mean softmax. Sequences identical to JAX's, scores
    within 1e-4; the port's dev-mode decode gives the same sequences."""
    rs = np.random.RandomState(0)
    src = rs.randint(3, 20, (4, 7)).astype(np.int32)
    src[0, 4:] = 0
    src[2] = 0                  # an all-pad row
    cfgs = [tiny_config(model_name=n, beam_size=3, **SIZE) for n in NAMES]
    jparams = [jget_model(n).init_fn(jax.random.PRNGKey(i), c)
               for i, (n, c) in enumerate(zip(NAMES, cfgs))]
    jinf = jtrain.make_ensemble_inference(
        [jget_model(n).infer_fn(c) for n, c in zip(NAMES, cfgs)])
    want = jax.jit(lambda p, x: jbeam_search(p, x, jinf, cfgs[0]))(
        jparams, jnp.asarray(src))
    out = []
    for mode in ("cache", "dev"):
        pcfgs = [port_config(c, search_mode=mode) for c in cfgs]
        params = [bridge(jp, get_model(n).init_fn(torch.Generator(), c))
                  for jp, n, c in zip(jparams, NAMES, pcfgs)]
        inf = train.make_ensemble_inference(
            [get_model(n).infer_fn(c) for n, c in zip(NAMES, pcfgs)])
        da.launches.clear()
        with torch.inference_mode():
            out.append(beam_search(params, t(src).long(), inf, pcfgs[0]))
        if mode == "cache":
            assert dict(+da.launches) == {
                "decode_pool_attention_ref": out[0]["steps"],
                "decode_pool_attention_relu_ref": out[0]["steps"]}
    np.testing.assert_array_equal(out[0]["seq"].numpy(),
                                  np.asarray(want["seq"]))
    np.testing.assert_allclose(out[0]["score"].numpy(),
                               np.asarray(want["score"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(out[1]["seq"].numpy(),
                                  out[0]["seq"].numpy())


def test_mode_ensemble_reads_jax_checkpoints_and_matches_jax(tmp_path):
    """Two model directories, each with the JAX Saver's checkpoint and a
    param.json naming its model; the command line gives the files and the
    search. Both CLIs write the same translations."""
    rs = np.random.RandomState(3)
    words = ["tok%d" % i for i in range(14)]
    with open(tmp_path / "vocab.txt", "w") as w:
        w.write("\n".join(words) + "\n")
    lines = [" ".join(rs.choice(words, rs.randint(2, 9))) for _ in range(6)]
    for name in ("test.src", "test.tgt"):
        with open(tmp_path / name, "w") as w:
            w.write("\n".join(lines) + "\n")
    dirs = []
    for i, name in enumerate(NAMES):
        model_dir = str(tmp_path / name)
        cfg = default_config().parse(
            "model_name=%s,hidden_size=16,embed_size=16,filter_size=32,"
            "num_heads=2,num_encoder_layer=1,num_decoder_layer=1,"
            "shared_source_target_embedding=True" % name)
        save_parameters(cfg, model_dir)
        cfg.src_vocab = cfg.tgt_vocab = JVocab(str(tmp_path / "vocab.txt"))
        params = jget_model(name).init_fn(jax.random.PRNGKey(7 + i), cfg)
        JSaver(output_dir=model_dir).save({"params": params}, step=1)
        dirs.append(model_dir)
    spec = ("beam_size=3,decode_length=6,decode_max_len=24,"
            "eval_batch_size=8,pad_seq_multiple=4,"
            "src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
            "test_output={0}/%s.txt".format(tmp_path))
    jrun.main(["--mode", "ensemble", "--ensemble_dirs", ";".join(dirs),
               "--parameters", spec % "jax"])
    summary = run.main(["--mode", "ensemble", "--ensemble_dirs",
                        ";".join(dirs), "--parameters",
                        spec % "port" + ",device=cpu"])
    with open(tmp_path / "jax.txt") as r:
        want = r.read().splitlines()
    with open(tmp_path / "port.txt") as r:
        got = r.read().splitlines()
    assert got == want and len(got) == 6
    assert summary["sentences"] == 6 and summary["steps"] > 0
    assert 0.0 <= summary["bleu"] <= 1.0
