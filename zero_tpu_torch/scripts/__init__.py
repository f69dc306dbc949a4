"""Tools of the port: the profilers and kernel sweeps of the card
(``profile_train``, ``profile_decode``, ``decode_split_sweep``,
``rpr_forward_times``) and the offline tools copied from
``zero_tpu/scripts`` (``checkpoint_averaging``, ``chrf``,
``bleu_over_length``, ``shuffle_corpus``, ``make_synth_mt``,
``evaluate_pos_translation_rate``)."""
