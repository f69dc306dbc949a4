"""zero_tpu_torch refuses what it has not ported instead of ignoring it:
the 'pipe' mesh axis raises in ``--mode train``, and so do the 'seq'
axis for a model outside SP_MODELS (and beside the 'expert' axis or
ROBT) and the 'expert' axis for one other than transformer_moe, each
naming the model, while the 'model' axis runs for every model; a mesh
that one process cannot hold raises make_mesh's ValueError (the
defaults, ZeRO, the sharded checkpoint, MoE over processes and tensor,
sequence and expert parallelism over enough processes do not), and
``--mode test`` with a mesh decodes on the one device with the JAX
package's warning. And ``decode_split_sweep.py --package DIR`` imports
DIR's zero_tpu_torch in a fresh process."""

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from zero_tpu_torch import run  # noqa: E402
from zero_tpu_torch.config import default_config  # noqa: E402
from zero_tpu_torch.models.common import check_ported  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("option,error,match", [
    # one process holds one device: a model or expert degree of two
    # needs two processes
    ("mesh_model=2", ValueError, "make_mesh needs.*\\*2\\*1\\*1\\*1 ="),
    ("mesh_seq=2", ValueError, "make_mesh needs.*\\*1\\*2\\*1\\*1 ="),
    ("mesh_pipe=2", NotImplementedError, "mesh_pipe=2.*later slice"),
    ("mesh_expert=2", ValueError, "make_mesh needs.*\\*1\\*1\\*1\\*2 ="),
    # one device a process: the 'data' degree is the number of processes
    ("mesh_data=2", ValueError, "make_mesh needs.*mesh_data")])
def test_parallel_options_raise_in_training(option, error, match):
    """Each raises before any work (no files are given), naming itself;
    mesh_data and dist_num_processes run (data parallelism), with ZeRO,
    the sharded checkpoint and transformer_moe."""
    with pytest.raises(error, match=match):
        run.main(["--mode", "train", "--parameters", "device=cpu," + option])


LATER_TP = ["transformer_aan", "transformer_fuse",
            "transformer_multilingual", "transformer_clsr",
            "transformer_ibdecoder", "transformer_afs", "rnnsearch",
            "deepnmt", "rnnsearch_deepatt"]


@pytest.mark.parametrize("name", LATER_TP)
def test_mesh_model_raises_for_a_model_of_a_later_slice(name):
    """Two processes at mesh_model=2: these nine models raised here until
    their tensor parallelism was ported; now every model trains on a
    'model' axis (tests/test_torch_tensor_parallel_models.py), and
    check_ported passes."""
    cfg = default_config()
    cfg.parse("device=cpu,mesh_model=2,model_name=" + name)
    assert check_ported(cfg, world=2) is None


LATER_SP = ["transformer_aan", "transformer_fuse", "transformer_moe",
            "transformer_ibdecoder", "transformer_afs", "transformer_fixup",
            "rnnsearch", "deepnmt", "rnnsearch_deepatt"]


@pytest.mark.parametrize("name", LATER_SP)
def test_mesh_seq_raises_for_a_model_of_a_later_slice(name):
    """Two processes at mesh_seq=2: the models outside SP_MODELS raise,
    naming themselves and the later slice."""
    cfg = default_config()
    cfg.parse("device=cpu,mesh_seq=2,model_name=" + name)
    with pytest.raises(NotImplementedError,
                       match="mesh_seq=2 for %s.*later slice" % name):
        check_ported(cfg, world=2)


@pytest.mark.parametrize("option", [
    "mesh_seq=2,mesh_expert=2,model_name=transformer_moe",
    "mesh_seq=2,robt=true,model_name=transformer_multilingual"])
def test_mesh_seq_with_expert_parallelism_or_robt_raises(option):
    cfg = default_config()
    cfg.parse("device=cpu," + option)
    with pytest.raises(NotImplementedError, match="mesh_seq=2.*later slice"):
        check_ported(cfg, world=4 if "expert" in option else 2)


@pytest.mark.parametrize("option", [
    "model_name=transformer,mesh_seq=2",
    "model_name=transformer_rpr,mesh_seq=2,zero_stage=3",
    "model_name=transformer_rela,mesh_seq=2,mesh_data=2,zero_stage=1",
    "model_name=transformer_multilingual,mesh_seq=2",
    "model_name=transformer_clsr,mesh_seq=2",
    "model_name=transformer_l0drop,mesh_seq=2",
    "model_name=transformer,mesh_seq=2,mesh_model=2"])
def test_sequence_parallelism_runs_in_training(option):
    cfg = default_config()
    cfg.parse("device=cpu," + option)
    world = 4 if "mesh_data=2" in option or "mesh_model=2" in option else 2
    check_ported(cfg, world=world)


@pytest.mark.parametrize("option", [
    "model_name=transformer,mesh_model=2",
    "model_name=transformer_rpr,mesh_model=2,zero_stage=3",
    "model_name=transformer_moe,mesh_model=2",
    "model_name=transformer_moe,mesh_expert=2",
    "model_name=transformer,mesh_model=2,mesh_data=2,zero_stage=1"])
def test_tensor_and_expert_parallelism_run_in_training(option):
    cfg = default_config()
    cfg.parse("device=cpu," + option)
    world = 4 if "mesh_data=2" in option else 2
    check_ported(cfg, world=world)


def test_expert_parallelism_raises_for_other_models_and_odd_heads():
    cfg = default_config()
    cfg.parse("device=cpu,mesh_expert=2,model_name=transformer")
    with pytest.raises(NotImplementedError,
                       match="mesh_expert=2 for transformer.*later slice"):
        check_ported(cfg, world=2)
    cfg = default_config()
    cfg.parse("device=cpu,mesh_model=3,num_heads=8,model_name=transformer")
    with pytest.raises(ValueError, match="num_heads 8.*mesh_model 3"):
        check_ported(cfg, world=3)


def test_expert_parallelism_under_scan_layers_raises():
    """Expert parallelism under scan_layers raised here until it was
    ported: transformer_moe ignores scan_layers (its own init_fn, as in
    the JAX package), so its experts split as without it, and
    check_ported passes; so does tensor parallelism under scan_layers."""
    cfg = default_config()
    cfg.parse("device=cpu,mesh_expert=2,model_name=transformer_moe,"
              "scan_layers=true")
    assert check_ported(cfg, world=2) is None
    cfg = default_config()
    cfg.parse("device=cpu,mesh_model=2,model_name=transformer_moe,"
              "scan_layers=true,use_remat=true")
    check_ported(cfg, world=2)


@pytest.mark.parametrize("option", [
    "zero_stage=1", "sharded_checkpoint=true",
    "model_name=transformer_moe,dist_num_processes=2"],
    ids=["zero_stage=1", "sharded_checkpoint=true",
         "model_name=transformer_moe,dist_num_processes=2"])
def test_zero_sharded_checkpoint_and_moe_run_in_data_parallel_training(
        option):
    """ZeRO, the sharded checkpoint's write side and transformer_moe under
    data parallelism are ported: two processes pass."""
    cfg = default_config()
    cfg.parse("device=cpu," + option)
    check_ported(cfg, world=2)


@pytest.mark.parametrize("option", ["", "mesh_data=-1", "mesh_data=0",
                                    "mesh_data=1,mesh_model=1,zero_stage=0"])
def test_defaults_do_not_raise(option):
    cfg = default_config()
    cfg.parse(option)
    check_ported(cfg)
    check_ported(cfg, training=False)


def test_mode_test_with_a_mesh_decodes_on_one_device(tmp_path, caplog):
    rs = np.random.RandomState(3)
    words = ["tok%d" % i for i in range(14)]
    with open(tmp_path / "vocab.txt", "w") as w:
        w.write("\n".join(words) + "\n")
    lines = [" ".join(rs.choice(words, rs.randint(2, 9))) for _ in range(4)]
    for name in ("test.src", "test.tgt"):
        with open(tmp_path / name, "w") as w:
            w.write("\n".join(lines) + "\n")
    spec = ("device=cpu,mesh_model=2,model_name=transformer,"
            "hidden_size=16,embed_size=16,"
            "filter_size=32,num_heads=2,num_encoder_layer=1,"
            "num_decoder_layer=1,beam_size=2,decode_length=4,"
            "eval_batch_size=4,src_vocab_file={0}/vocab.txt,"
            "tgt_vocab_file={0}/vocab.txt,src_test_file={0}/test.src,"
            "tgt_test_file={0}/test.tgt,output_dir={0}/out,"
            "test_output={0}/trans.txt".format(tmp_path))
    with caplog.at_level(logging.WARNING):
        summary = run.main(["--mode", "test", "--parameters", spec])
    assert summary["sentences"] == 4
    assert any("decoding on one device" in r.getMessage()
               and "mesh_model=2" in r.getMessage() for r in caplog.records)


def test_split_sweep_package_imports_that_checkout(tmp_path):
    """A stub checkout whose decode-attention module stops the sweep at
    import: the first line the sweep prints names the stub's package, and
    the stub's exit code comes back."""
    kernels = tmp_path / "zero_tpu_torch" / "ops" / "kernels"
    kernels.mkdir(parents=True)
    for d in (kernels.parents[1], kernels.parent, kernels):
        (d / "__init__.py").write_text("")
    (kernels / "decode_attention.py").write_text(
        "import sys\nprint('stub decode_attention', flush=True)\n"
        "sys.exit(7)\n")
    out = subprocess.run(
        [sys.executable, "-m", "zero_tpu_torch.scripts.decode_split_sweep",
         "--package", str(tmp_path), "--lengths", "114"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    lines = out.stdout.splitlines()
    assert out.returncode == 7, out.stderr
    assert json.loads(lines[0]) == {
        "zero_tpu_torch": str(tmp_path / "zero_tpu_torch" / "__init__.py")}
    assert lines[1] == "stub decode_attention"
