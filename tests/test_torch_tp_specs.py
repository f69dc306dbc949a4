"""The port's partition table (zero_tpu_torch/parallel/mesh.py) against
the JAX package's rules (``zero_tpu/parallel/mesh.py``), on the CPU: the
port of ``tests/test_tp_specs.py``.

For all 15 models the port's ``param_specs`` puts 'model' on exactly the
leaves and dims where ``param_sharding`` does (mesh data 4 x model 2), and
the ZeRO dim on top of it where ``zero1_sharding`` puts 'data'; the
stacked [L, ...] specs, the divisibility fallback, the expert rule and
``unsharded_big_params``' reports are JAX's. Every rank's rectangles
(Layout.pieces) tile every leaf exactly once, the fused qkv's three
blocks included, and hold the rank's values.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from test_tp_specs import EXPECTED, _cfg  # noqa: E402
from torch_parity import port_config  # noqa: E402
from zero_tpu.models.base import get_model as jget_model  # noqa: E402
from zero_tpu.parallel.mesh import (make_mesh, param_sharding,  # noqa: E402
                                    spec_for_param as jspec,
                                    unsharded_big_params as jbig,
                                    zero1_sharding)
from zero_tpu_torch.models import get_model  # noqa: E402
from zero_tpu_torch.parallel import mesh  # noqa: E402
from zero_tpu_torch.parallel.distributed import Grid  # noqa: E402


def _over(name):
    return dict(num_languages=4, lang_id_offset=3) \
        if name in ("transformer_multilingual", "transformer_clsr") else {}


def _jax_axes(params, jmesh, zero):
    """{port name: spec tuple padded to the leaf's rank} of
    param_sharding (and zero1_sharding's 'data' with ``zero``)."""
    specs = param_sharding(params, jmesh, warn_unsharded=False)
    if zero:
        specs = zero1_sharding(params, jmesh, specs)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        out[name] = s.spec
    return out


def _port_shapes(cfg):
    module = get_model(cfg.model_name).init_fn(torch.Generator(),
                                               port_config(cfg))
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_the_model_axis_lands_where_param_sharding_puts_it(name):
    cfg = _cfg(name, **_over(name))
    params = jget_model(name).init_fn(jax.random.PRNGKey(0), cfg)
    jmesh = make_mesh(data=4, model=2)
    want = _jax_axes(params, jmesh, zero=False)
    shapes = _port_shapes(cfg)
    got = mesh.param_specs(shapes, model=2)
    assert sorted(got) == sorted(want)
    for n, shape in shapes.items():
        padded = tuple(want[n]) + (None,) * (len(shape) - len(want[n]))
        assert got[n] == padded, n
    # the short names of the split leaves: test_tp_specs.EXPECTED
    split = {"/".join(p for p in n.split(".")
                      if p not in ("ws", "b") and not p.isdigit())
             for n, s in got.items() if "model" in s}
    assert split == EXPECTED[name]


@pytest.mark.parametrize("name", ["transformer", "transformer_moe"])
def test_zero_goes_on_the_first_free_dim_as_zero1_sharding(name):
    cfg = _cfg(name)
    params = jget_model(name).init_fn(jax.random.PRNGKey(0), cfg)
    want = _jax_axes(params, make_mesh(data=4, model=2), zero=True)
    shapes = _port_shapes(cfg)
    named = [(n, torch.zeros(s)) for n, s in shapes.items()]
    layout = mesh.Layout.plan(named, Grid({"data": 4, "model": 2}, 0),
                              zero=True)
    for n, spec in want.items():
        axes = list(spec) + [None] * (len(shapes[n]) - len(spec))
        assert layout.dims[n] == (axes.index("data") if "data" in axes
                                  else None), n


def test_scan_layers_stacked_specs():
    assert mesh.spec_for_param("encoder/self/qkv/ws/0", (4, 64, 192)) \
        == tuple(jspec("encoder/self/qkv/ws/0", (4, 64, 192)))
    assert mesh.spec_for_param("encoder/ffn/output/ws/0", (4, 128, 64)) \
        == (None, "model", None)
    cfg = _cfg("transformer", scan_layers=True)
    specs = mesh.param_specs(_port_shapes(cfg), model=2)
    assert specs["encoder.self.qkv.ws.0"] == (None, None, "model")
    assert specs["decoder.ffn.output.ws.0"] == (None, "model", None)


def test_param_sharding_divisibility_fallback():
    specs = mesh.param_specs({"enlarge.ws.0": (16, 33),
                              "src_embedding": (61, 16),
                              "o.ws.0": (16, 16)}, model=2)
    assert specs == {"enlarge.ws.0": (None, None),
                     "src_embedding": (None, None),
                     "o.ws.0": ("model", None)}


@pytest.mark.parametrize("name", ["transformer", "transformer_multilingual",
                                  "rnnsearch"])
def test_no_silent_tp_degradation(name):
    cfg = _cfg(name, hidden_size=64, embed_size=64, filter_size=128,
               **_over(name))
    params = jget_model(name).init_fn(jax.random.PRNGKey(0), cfg)
    assert jbig(params, make_mesh(data=4, model=2), min_elems=64 * 64) == []
    assert mesh.unsharded_big_params(_port_shapes(cfg), 2,
                                     min_elems=64 * 64) == []


def test_renamed_param_is_reported(caplog):
    shapes = {"decoder.0.myattn.query_projection_new_name.ws.0": (256, 256)}
    want = ["decoder/0/myattn/query_projection_new_name/ws/0"]
    assert mesh.unsharded_big_params(shapes, 2, min_elems=1024) == want
    assert jbig({"decoder": {"0": {"myattn": {"query_projection_new_name": {
        "ws": [np.zeros((256, 256))]}}}}}, make_mesh(data=4, model=2),
        min_elems=1024) == want
    assert mesh.unsharded_big_params(shapes, 1, min_elems=1024) == []
    with caplog.at_level("WARNING"):
        mesh.warn_unsharded({k: (512, 512) for k in shapes}, 2)
    assert any("matched no partition rule" in r.getMessage()
               for r in caplog.records)


@pytest.mark.parametrize("zero", [False, True])
def test_every_rank_s_rectangles_tile_every_leaf(zero):
    """Over the mesh data 2 x model 2, each rank's pieces of every leaf
    (parameters whole over 'data', or ZeRO shards) are its values at
    their index keys, and the ranks that write them cover each leaf
    exactly once; the fused qkv's part is three rectangles."""
    cfg = _cfg("transformer", num_heads=4, **{})
    shapes = _port_shapes(cfg)
    rs = np.random.RandomState(0)
    wholes = {n: torch.from_numpy(rs.randn(*s).astype(np.float32))
              for n, s in shapes.items()}
    named = list(wholes.items())
    cover = {n: np.zeros(s, np.int32) for n, s in shapes.items()}
    for rank in range(4):
        layout = mesh.Layout.plan(named, Grid({"data": 2, "model": 2}, rank),
                                  zero=zero)
        for n, whole in wholes.items():
            held = layout.held(n, whole) if zero else layout.part(n, whole)
            sharded = zero and layout.is_shard(n, held)
            if not layout.writes(n, sharded):
                continue
            pieces = layout.pieces(n, held, sharded)
            if n.endswith("self.qkv.ws.0"):
                assert len(pieces) == 3
            for key, piece in pieces:
                index = tuple(slice(*map(int, span.split(":")))
                              for span in key.split(","))
                np.testing.assert_array_equal(piece.numpy(),
                                              whole.numpy()[index])
                cover[n][index] += 1
    for n, c in cover.items():
        assert (c == 1).all(), n


def _short(names):
    return {"/".join(p for p in n.replace(".", "/").split("/")
                     if p not in ("ws", "b") and not p.isdigit())
            for n in names}


@pytest.mark.parametrize("ctc", [False, True], ids=["no_ctc", "ctc"])
def test_afs_split_set_is_the_one_spec_for_param_gives(ctc):
    """transformer_afs has no row in test_tp_specs.EXPECTED: its split set
    is computed here from JAX's spec_for_param over the JAX init_fn's
    leaves (the encoders' and decoder's core, the decoder's cross
    attention, tgt_embedding; never the frontend, the gates or
    ctc_head), and the port's param_specs split the same leaves on the
    same dims as param_sharding. ctc_head matches no rule: both packages
    report it as a large weight left whole."""
    cfg = _cfg("transformer_afs", data_kind="speech", audio_num_mel_bins=8,
               num_st_encoder_layer=1, ctc_enable=ctc,
               coarse_label_base=60)
    params = jget_model("transformer_afs").init_fn(jax.random.PRNGKey(0),
                                                   cfg)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    paths = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path): leaf.shape for path, leaf in flat}
    want = _short(p for p, shape in paths.items()
                  if "model" in tuple(jspec(p, shape)))
    assert {"asr_encoder/self/qkv", "st_encoder/ffn/enlarge",
            "decoder/cross/v", "tgt_embedding"} <= want
    assert not want & {"frontend", "afs_temporal", "afs_feature",
                       "ctc_head"}
    jmesh = make_mesh(data=4, model=2)
    axes = _jax_axes(params, jmesh, zero=False)
    shapes = _port_shapes(cfg)
    got = mesh.param_specs(shapes, model=2)
    assert _short(n for n, s in got.items() if "model" in s) == want
    for n, shape in shapes.items():
        assert got[n] == tuple(axes[n]) + (None,) * (
            len(shape) - len(axes[n])), n
    big = jbig(params, jmesh, min_elems=16 * 60)
    assert mesh.unsharded_big_params(shapes, 2, min_elems=16 * 60) == big
    assert big == (["ctc_head/ws/0"] if ctc else [])
