"""zero_tpu_torch's deepnmt and rnnsearch_deepatt against zero_tpu: the
model tests of test_torch_rnn_models.py (init key set, train_fn, score_fn,
beam search at beam 3 and 1, cache against dev decode, a checkpoint across
the packages) over these models' configurations, in a file of their own
so that each file stays short on one test worker."""

import pytest

pytest.importorskip("torch")

from test_torch_rnn_models import (  # noqa: E402,F401
    config_id, make_setup, test_beam_search_matches_jax,
    test_cache_decode_equals_dev_decode,
    test_checkpoint_round_trips_across_the_packages,
    test_init_key_set_and_shapes_match_jax, test_score_fn_matches_jax,
    test_train_fn_matches_jax)

CONFIGS = [
    ("deepnmt", dict(cell="gru", caencoder=False, use_deep_att=False)),
    ("deepnmt", dict(cell="gru", caencoder=True, use_deep_att=False)),
    ("deepnmt", dict(cell="lstm", caencoder=False, use_deep_att=True)),
    # embed_size != hidden_size: x_map and x_map_ln
    ("deepnmt", dict(cell="sru", caencoder=True, embed_size=12,
                     layer_norm=True)),
    ("rnnsearch_deepatt", dict(cell="gru")),
    ("rnnsearch_deepatt", dict(cell="olrn", layer_norm=True)),
]


# the imported tests take this module's configurations through this
# fixture, which overrides the one of test_torch_rnn_models.py
@pytest.fixture(scope="module", params=CONFIGS, ids=config_id)
def setup(request):
    return make_setup(*request.param)
