"""Experiment configuration: INI `.cfg` parsing with full key parity.

The PyTorch port's own copy of ``tpu_slu/config.py`` (the port imports
nothing of the JAX package), key for key: ``read_config(path).to_dict()``
equals the JAX package's on every shipped cfg (``tests/test_torch_config.py``).
Keys that only the JAX package reads (``gru_impl``, ``prng_impl``,
``checkpoint_backend``, ``model_parallel`` ...) are parsed all the same, so
one cfg serves both packages.

Reproduces every key, derived field, optional-key fallback, and filesystem
side effect of the reference's ``read_config`` (reference ``data.py:19-130``):

* ``[experiment]`` seed/folder; creates ``<folder>/{pretraining,training}/``
  and archives the cfg as ``<folder>/experiment.cfg``.
* ``[phoneme_module]``, ``[word_module]``, ``[intent_module]`` topology lists.
* Optional seq2seq hyperparameters (reference ``data.py:66-74``), ``augment``
  (``103-107``), ``seq2seq`` (``109-113``), ``dataset_upsample_factor``
  (``115-119``) — all default silently like the reference's try/except.
* Derived: ``starting_unfreezing_index`` from ``pretraining_type``
  (``data.py:79-82``) and ``phone/word_downsample_factor`` products
  (``data.py:121-128``; 640 and 2560 for the default cfg → 25 Hz / 6.25 Hz
  label rates).

Dataset-derived fields (``Sy_intent``, ``values_per_slot``,
``num_phonemes``) are late-bound: the port attaches them from a saved
``vocab.json`` (``Model.attach_vocab``) before model construction.
``Config.require(name)`` gives a clear error if the call order is violated
instead of an AttributeError deep inside model code.
"""

from __future__ import annotations

import configparser
import os
import shutil


class Config:
    """Attribute-bag experiment config (mirrors reference ``data.py:15-17``).

    Mutable by design: the data layer attaches ``Sy_intent`` /
    ``values_per_slot`` / ``num_phonemes`` after reading the datasets, exactly
    like the reference's call protocol.
    """

    # Fields attached late by the data layer rather than read_config.
    _LATE_BOUND = ("Sy_intent", "values_per_slot", "num_phonemes")

    def __init__(self):
        self.use_sincnet = True

    def require(self, name: str):
        """Fetch an attribute, explaining the call-order contract if absent."""
        try:
            return getattr(self, name)
        except AttributeError:
            if name in self._LATE_BOUND:
                raise RuntimeError(
                    f"config.{name} is not set. It is derived from the dataset: "
                    "call get_SLU_datasets(config) / get_ASR_datasets(config) "
                    "before constructing a model (this mirrors the reference's "
                    "required call order, reference data.py:191-233)."
                ) from None
            raise

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    def __repr__(self):  # pragma: no cover - debugging aid
        keys = ", ".join(sorted(self.to_dict()))
        return f"Config({keys})"


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",")]


def _floats(s: str) -> list[float]:
    return [float(x) for x in s.split(",")]


def _strs(s: str) -> list[str]:
    return list(s.split(","))


def read_config(config_file: str, make_dirs: bool = True) -> Config:
    """Parse a `.cfg` experiment file into a :class:`Config`.

    Key-for-key compatible with the reference (``data.py:19-130``), including
    the 24 bundled experiment cfg formats. ``make_dirs=False`` skips the
    folder-creation/copy side effects (useful for read-only inspection).
    """
    config = Config()
    parser = configparser.ConfigParser()
    if not parser.read(config_file):
        raise FileNotFoundError(f"config file not found or empty: {config_file}")

    # [experiment]
    config.seed = parser.getint("experiment", "seed")
    config.folder = parser.get("experiment", "folder")

    if make_dirs:
        # Archive experiment info (reference data.py:29-33; shutil instead of
        # `cp` through a shell). exist_ok: the ranks of a data-parallel run
        # read the config at once.
        for sub in ("pretraining", "training"):
            os.makedirs(os.path.join(config.folder, sub), exist_ok=True)
        shutil.copyfile(config_file, os.path.join(config.folder, "experiment.cfg"))

    # [phoneme_module]
    config.use_sincnet = parser.get("phoneme_module", "use_sincnet") == "True"
    config.fs = parser.getint("phoneme_module", "fs")

    config.cnn_N_filt = _ints(parser.get("phoneme_module", "cnn_N_filt"))
    config.cnn_len_filt = _ints(parser.get("phoneme_module", "cnn_len_filt"))
    config.cnn_stride = _ints(parser.get("phoneme_module", "cnn_stride"))
    config.cnn_max_pool_len = _ints(parser.get("phoneme_module", "cnn_max_pool_len"))
    config.cnn_act = _strs(parser.get("phoneme_module", "cnn_act"))
    config.cnn_drop = _floats(parser.get("phoneme_module", "cnn_drop"))

    config.phone_rnn_num_hidden = _ints(parser.get("phoneme_module", "phone_rnn_num_hidden"))
    config.phone_downsample_len = _ints(parser.get("phoneme_module", "phone_downsample_len"))
    config.phone_downsample_type = _strs(parser.get("phoneme_module", "phone_downsample_type"))
    config.phone_rnn_drop = _floats(parser.get("phoneme_module", "phone_rnn_drop"))
    config.phone_rnn_bidirectional = (
        parser.get("phoneme_module", "phone_rnn_bidirectional") == "True"
    )

    # [word_module]
    config.word_rnn_num_hidden = _ints(parser.get("word_module", "word_rnn_num_hidden"))
    config.word_downsample_len = _ints(parser.get("word_module", "word_downsample_len"))
    config.word_downsample_type = _strs(parser.get("word_module", "word_downsample_type"))
    config.word_rnn_drop = _floats(parser.get("word_module", "word_rnn_drop"))
    config.word_rnn_bidirectional = parser.get("word_module", "word_rnn_bidirectional") == "True"
    config.vocabulary_size = parser.getint("word_module", "vocabulary_size")

    # [intent_module]
    config.intent_rnn_num_hidden = _ints(parser.get("intent_module", "intent_rnn_num_hidden"))
    config.intent_downsample_len = _ints(parser.get("intent_module", "intent_downsample_len"))
    config.intent_downsample_type = _strs(parser.get("intent_module", "intent_downsample_type"))
    config.intent_rnn_drop = _floats(parser.get("intent_module", "intent_rnn_drop"))
    config.intent_rnn_bidirectional = (
        parser.get("intent_module", "intent_rnn_bidirectional") == "True"
    )
    # Optional seq2seq hyperparameters (reference data.py:66-74).
    try:
        config.intent_encoder_dim = parser.getint("intent_module", "intent_encoder_dim")
        config.num_intent_encoder_layers = parser.getint(
            "intent_module", "num_intent_encoder_layers"
        )
        config.intent_decoder_dim = parser.getint("intent_module", "intent_decoder_dim")
        config.num_intent_decoder_layers = parser.getint(
            "intent_module", "num_intent_decoder_layers"
        )
        config.intent_decoder_key_dim = parser.getint("intent_module", "intent_decoder_key_dim")
        config.intent_decoder_value_dim = parser.getint(
            "intent_module", "intent_decoder_value_dim"
        )
    except (configparser.Error, ValueError):
        pass  # no seq2seq hyperparameters in this cfg
    # Extension: dropout rate inside the seq2seq head. The reference
    # HARDCODES p=0.5 in Seq2SeqEncoder and DecoderRNN (models.py:403,454)
    # — appropriate for Timers-and-Such-scale data, but it dominates the
    # optimization on small tasks (measured: the synthetic 336-combo demo
    # mode-collapses its first decode slot under 0.5 while converging at
    # lower rates). Default 0.5 = reference parity.
    try:
        config.seq2seq_dropout = parser.getfloat("intent_module", "seq2seq_dropout")
    except (configparser.Error, ValueError):
        config.seq2seq_dropout = 0.5
    # Extension: train the first decode step on the zeros vector that beam
    # inference actually feeds. The reference trains u=0 on one-hot SOS
    # (models.py:536-538) but decodes u=0 from zeros (models.py:600) — a
    # train/decode mismatch on exactly one step; first-token-informative
    # tasks decode that token as the marginal mode. Default False =
    # reference parity (bug preserved).
    try:
        config.seq2seq_zeros_start = (
            parser.get("intent_module", "seq2seq_zeros_start") == "True"
        )
    except configparser.Error:
        config.seq2seq_zeros_start = False

    # [pretraining]
    config.asr_path = parser.get("pretraining", "asr_path")
    # 0 - none, 1 - phoneme, 2 - phoneme + word, 3 - word (reference data.py:78)
    config.pretraining_type = parser.getint("pretraining", "pretraining_type")
    if config.pretraining_type == 0:
        config.starting_unfreezing_index = (
            1
            + len(config.word_rnn_num_hidden)
            + len(config.phone_rnn_num_hidden)
            + len(config.cnn_N_filt)
        )
    elif config.pretraining_type in (1,):
        config.starting_unfreezing_index = 1 + len(config.word_rnn_num_hidden)
    else:  # 2, 3
        config.starting_unfreezing_index = 1
    config.pretraining_lr = parser.getfloat("pretraining", "pretraining_lr")
    config.pretraining_batch_size = parser.getint("pretraining", "pretraining_batch_size")
    config.pretraining_num_epochs = parser.getint("pretraining", "pretraining_num_epochs")
    config.pretraining_length_mean = parser.getfloat("pretraining", "pretraining_length_mean")
    config.pretraining_length_var = parser.getfloat("pretraining", "pretraining_length_var")

    # [training]
    config.slu_path = parser.get("training", "slu_path")
    config.unfreezing_type = parser.getint("training", "unfreezing_type")
    config.training_lr = parser.getfloat("training", "training_lr")
    config.training_batch_size = parser.getint("training", "training_batch_size")
    config.training_num_epochs = parser.getint("training", "training_num_epochs")
    config.real_dataset_subset_percentage = parser.getfloat(
        "training", "real_dataset_subset_percentage"
    )
    config.synthetic_dataset_subset_percentage = parser.getfloat(
        "training", "synthetic_dataset_subset_percentage"
    )
    config.real_speaker_subset_percentage = parser.getfloat(
        "training", "real_speaker_subset_percentage"
    )
    config.synthetic_speaker_subset_percentage = parser.getfloat(
        "training", "synthetic_speaker_subset_percentage"
    )
    config.train_wording_path = parser.get("training", "train_wording_path")
    if config.train_wording_path == "None":
        config.train_wording_path = None
    config.test_wording_path = parser.get("training", "test_wording_path")
    if config.test_wording_path == "None":
        config.test_wording_path = None
    try:
        config.augment = parser.get("training", "augment") == "True"
    except configparser.Error:
        config.augment = False  # old config file with no augmentation
    try:
        config.seq2seq = parser.get("training", "seq2seq") == "True"
    except configparser.Error:
        config.seq2seq = False  # old config file with no seq2seq
    try:
        config.dataset_upsample_factor = parser.getint("training", "dataset_upsample_factor")
    except configparser.Error:
        config.dataset_upsample_factor = 1  # old config file
    # Extension over the reference: optional global-norm gradient clipping
    # (0 = off, reference behavior). Stacked GRUs occasionally spike grad
    # norms >100x; clipping stabilizes higher learning rates.
    try:
        config.gradient_clip_norm = parser.getfloat("training", "gradient_clip_norm")
    except configparser.Error:
        config.gradient_clip_norm = 0.0
    # Extension: GRU implementation. "auto" (default) uses the fused Pallas
    # kernels on TPU and lax.scan elsewhere; "scan"/"pallas" force one.
    try:
        config.gru_impl = parser.get("training", "gru_impl")
    except configparser.Error:
        config.gru_impl = "auto"
    # Extension: compute dtype for the GRU gate streams ("float32" default;
    # "bfloat16" halves the dominant HBM traffic — hidden-state recurrence
    # and losses stay float32 either way). The port's Trainer reads it
    # (training/trainer.py compute_dtype_of); any other value is float32.
    try:
        config.compute_dtype = parser.get("training", "compute_dtype")
    except configparser.Error:
        config.compute_dtype = "float32"
    # Extension: PRNG implementation for dropout keys ("rbg" default: fast
    # XLA RngBitGenerator; "threefry" for jax-default reproducibility).
    try:
        config.prng_impl = parser.get("training", "prng_impl")
    except configparser.Error:
        config.prng_impl = "rbg"
    # Extension: mask bucket padding out of the intent time-pool and seq2seq
    # attention (True default; False reproduces the reference's padding leak).
    try:
        config.mask_padding = parser.get("training", "mask_padding") != "False"
    except configparser.Error:
        config.mask_padding = True
    # Extension: checkpoint backend — "npz" (default, single portable file)
    # or "orbax" (multi-host-safe directory checkpoints for pod runs).
    try:
        config.checkpoint_backend = parser.get("training", "checkpoint_backend")
    except configparser.Error:
        config.checkpoint_backend = "npz"
    # Extension: torch.profiler trace directory of the first epoch's train
    # pass (off = None; utils/profiling.py).
    try:
        config.profile_dir = parser.get("training", "profile_dir")
        if config.profile_dir == "None":
            config.profile_dir = None
    except configparser.Error:
        config.profile_dir = None
    # Extension: first epoch at which seq2seq eval decodes strings for the
    # accuracy metric. Default 2 = reference parity (training.py:158 decodes
    # only when epoch > 1, so log.csv intent_acc is 0.0 until then); set 1 to
    # log decoded accuracy from the first eval.
    try:
        config.decode_acc_from_epoch = parser.getint("training", "decode_acc_from_epoch")
    except configparser.Error:
        config.decode_acc_from_epoch = 2
    # Extension: tensor parallelism degree. At >1 the ranks form a (data,
    # model) grid and the vocab heads are column-sharded over the model
    # axis, as the JAX package's mesh does (parallel/mesh.py). 1 = pure DP.
    try:
        config.model_parallel = parser.getint("training", "model_parallel")
    except configparser.Error:
        config.model_parallel = 1

    # Total time-decimation factors between waveform samples and label frames
    # (reference data.py:121-128).
    config.phone_downsample_factor = 1
    for factor in config.cnn_stride + config.cnn_max_pool_len + config.phone_downsample_len:
        config.phone_downsample_factor *= factor

    config.word_downsample_factor = 1
    for factor in (
        config.cnn_stride
        + config.cnn_max_pool_len
        + config.phone_downsample_len
        + config.word_downsample_len
    ):
        config.word_downsample_factor *= factor

    return config
