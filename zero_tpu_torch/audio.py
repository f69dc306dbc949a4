"""Audio frontend and speech dataset for end-to-end speech translation.

A copy of ``zero_tpu/audio.py`` (the port imports nothing of the JAX
package; that module is numpy and ``wave`` only): log-mel filterbank
inputs, frame-count-budgeted batching, transcript labels for CTC
regularization, and CoLaCTC coarse-label mapping (label mod base).

Manifest format (TSV), one utterance per line:
    <features>\t<transcript>\t<translation>
where <features> is a path to a `.npy` [T, n_mels] float array or a `.wav`
file (log-mel extracted on the fly via ``logmel``); relative paths are
taken from the manifest's directory.
"""

from __future__ import annotations

import os
import wave
from typing import Iterator, List, Optional, Tuple

import numpy as np

from zero_tpu_torch.data import batch_indexer, round_up, token_indexer


# ---------------------------------------------------------------------------
# log-mel filterbank (pure numpy; standard HTK-style mel scale)
# ---------------------------------------------------------------------------

def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(num_mels: int, n_fft: int, sample_rate: int,
                   fmin: float = 20.0, fmax: Optional[float] = None):
    """[n_fft//2+1, num_mels] triangular mel filter matrix."""
    fmax = fmax or sample_rate / 2.0
    mel_points = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2)
    hz_points = mel_to_hz(mel_points)
    bins = np.floor((n_fft + 1) * hz_points / sample_rate).astype(int)
    fbank = np.zeros((n_fft // 2 + 1, num_mels))
    for m in range(1, num_mels + 1):
        left, center, right = bins[m - 1], bins[m], bins[m + 1]
        for k in range(left, center):
            if center > left:
                fbank[k, m - 1] = (k - left) / (center - left)
        for k in range(center, right):
            if right > center:
                fbank[k, m - 1] = (right - k) / (right - center)
    return fbank


def logmel(waveform: np.ndarray, sample_rate: int = 16000,
           num_mels: int = 80, frame_length_ms: float = 25.0,
           frame_shift_ms: float = 10.0, eps: float = 1e-10) -> np.ndarray:
    """Log-mel filterbank features [T, num_mels] from a mono waveform."""
    waveform = np.asarray(waveform, np.float32)
    frame_len = int(sample_rate * frame_length_ms / 1000.0)
    frame_shift = int(sample_rate * frame_shift_ms / 1000.0)
    n_fft = 1
    while n_fft < frame_len:
        n_fft *= 2

    if len(waveform) < frame_len:
        waveform = np.pad(waveform, (0, frame_len - len(waveform)))
    num_frames = 1 + (len(waveform) - frame_len) // frame_shift
    idx = (np.arange(frame_len)[None, :]
           + frame_shift * np.arange(num_frames)[:, None])
    frames = waveform[idx] * np.hanning(frame_len)[None, :]

    spec = np.abs(np.fft.rfft(frames, n_fft, axis=1)) ** 2
    fbank = mel_filterbank(num_mels, n_fft, sample_rate)
    mel = spec @ fbank
    return np.log(mel + eps).astype(np.float32)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Mono waveform in [-1, 1] + sample rate from a 16-bit PCM wav."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        data = np.frombuffer(w.readframes(n), dtype=np.int16)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
    return data.astype(np.float32) / 32768.0, rate


def load_features(path: str, num_mels: int = 80) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".wav"):
        wav, rate = read_wav(path)
        return logmel(wav, rate, num_mels)
    raise ValueError("Unsupported feature file: %s" % path)


def coarse_labels(ids: List[int], base: int, num_specials: int = 3) -> List[int]:
    """CoLaCTC mapping: real token ids folded into a coarse label space of
    ``base`` classes via modulo (docs/colactc: 'simple operations to
    produce CoLaCTC labels'); special ids (<pad>/<unk>/<eos>) pass through."""
    out = []
    for i in ids:
        if i < num_specials:
            out.append(i)
        else:
            out.append(num_specials + (i - num_specials) % base)
    return out


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

class SpeechDataset:
    """Manifest-driven speech-translation dataset.

    Yields batches {'src': [B, T, n_mels] f32, 'src_mask': [B, T] f32,
    'tgt': [B, L] i32, 'transcript': [B, Ls] i32, 'index', 'raw'} with
    frame-budget bucketing mirroring the text pipeline's token_indexer.
    """

    def __init__(self, manifest: str, src_vocab, tgt_vocab,
                 max_len: int = 100, max_frame_len: int = 2048,
                 batch_or_token: str = "token", data_leak_ratio: float = 0.5,
                 num_mels: int = 80, pad_seq_multiple: int = 1,
                 pad_batch_multiple: int = 1, pad_batch_to: int = 0,
                 coarse_label_base: int = -1, context: bool = False,
                 context_max_frame_len: int = 1024):
        self.manifest = manifest
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.max_len = max_len
        self.max_frame_len = max_frame_len
        self.batch_or_token = batch_or_token
        self.data_leak_ratio = data_leak_ratio
        self.num_mels = num_mels
        self.pad_seq_multiple = pad_seq_multiple
        self.pad_batch_multiple = pad_batch_multiple
        self.pad_batch_to = pad_batch_to
        self.coarse_label_base = coarse_label_base
        # context-aware ST: attach the previous manifest segment's features
        # (manifest order = document order; docs/context_aware_st)
        self.context = context
        self.context_max_frame_len = context_max_frame_len
        self.leak_buffer: List = []

    def load_data(self) -> Iterator[Tuple[np.ndarray, List[int], List[int]]]:
        base = os.path.dirname(os.path.abspath(self.manifest))
        prev_feats = None
        with open(self.manifest) as reader:
            for line in reader:
                line = line.strip()
                if not line:
                    continue
                parts = line.split("\t")
                if len(parts) < 3:
                    continue
                feat_path, transcript, translation = parts[0], parts[1], parts[2]
                if not os.path.isabs(feat_path):
                    feat_path = os.path.join(base, feat_path)
                feats = load_features(feat_path, self.num_mels)
                feats = feats[:self.max_frame_len]
                asr_ids = self.src_vocab.to_id(
                    transcript.split()[:self.max_len])
                if self.coarse_label_base > 0:
                    asr_ids = coarse_labels(asr_ids, self.coarse_label_base)
                tgt_ids = self.tgt_vocab.to_id(
                    translation.split()[:self.max_len])
                if self.context:
                    # most recent frames of the previous segment
                    ctx = prev_feats[-self.context_max_frame_len:] \
                        if prev_feats is not None \
                        else np.zeros((1, self.num_mels), np.float32)
                    prev_feats = feats
                    yield feats, asr_ids, tgt_ids, ctx
                else:
                    yield feats, asr_ids, tgt_ids

    def to_matrix(self, batch):
        batch_size = len(batch)
        frame_len = round_up(max(s[1].shape[0] for s in batch),
                             self.pad_seq_multiple)
        asr_len = round_up(max(len(s[2]) for s in batch),
                           self.pad_seq_multiple)
        tgt_len = round_up(max(len(s[3]) for s in batch),
                           self.pad_seq_multiple)
        padded_bs = max(round_up(batch_size, self.pad_batch_multiple),
                        self.pad_batch_to)

        audio = np.zeros([padded_bs, frame_len, self.num_mels], np.float32)
        mask = np.zeros([padded_bs, frame_len], np.float32)
        asr = np.zeros([padded_bs, asr_len], np.int32)
        tgt = np.zeros([padded_bs, tgt_len], np.int32)
        ctx = ctx_mask = None
        if self.context:
            ctx_len = round_up(max(s[4].shape[0] for s in batch),
                               self.pad_seq_multiple)
            ctx = np.zeros([padded_bs, ctx_len, self.num_mels], np.float32)
            ctx_mask = np.zeros([padded_bs, ctx_len], np.float32)
        indices = []
        for eidx, sample in enumerate(batch):
            idx, feats, asr_ids, tgt_ids = sample[:4]
            indices.append(idx)
            t = feats.shape[0]
            audio[eidx, :t] = feats
            mask[eidx, :t] = 1.0
            asr[eidx, :len(asr_ids)] = asr_ids
            tgt[eidx, :len(tgt_ids)] = tgt_ids
            if self.context:
                tc = sample[4].shape[0]
                ctx[eidx, :tc] = sample[4]
                # all-zero context (first segment) keeps an all-zero mask
                if np.abs(sample[4]).sum() > 0:
                    ctx_mask[eidx, :tc] = 1.0
        return indices, audio, mask, asr, tgt, ctx, ctx_mask

    def batcher(self, size, buffer_size: int = 128, shuffle: bool = True,
                train: bool = True) -> Iterator[dict]:
        def _handle_buffer(buf):
            sorted_buf = sorted(buf, key=lambda s: s[1].shape[0])
            if self.batch_or_token == "batch":
                index_groups = batch_indexer(len(sorted_buf), size)
            else:
                # frame-count budget (frames dominate memory)
                index_groups = token_indexer(
                    [[s[1].shape[0], len(s[3])] for s in sorted_buf], size)
            order = list(range(len(index_groups)))
            if shuffle:
                np.random.shuffle(order)
            for oidx in order:
                batch = [sorted_buf[i] for i in index_groups[oidx]]
                idx, audio, mask, asr, tgt, ctx, ctx_mask = \
                    self.to_matrix(batch)
                out = {"src": audio, "src_mask": mask, "transcript": asr,
                       "tgt": tgt, "index": idx, "raw": batch}
                if ctx is not None:
                    out["context"] = ctx
                    out["context_mask"] = ctx_mask
                yield out

        buf = self.leak_buffer
        self.leak_buffer = []
        for i, sample in enumerate(self.load_data()):
            buf.append((i,) + tuple(sample))
            if len(buf) >= buffer_size:
                for data in _handle_buffer(buf):
                    n = len(data["raw"])
                    if train and n < 2 and self.batch_or_token == "batch" \
                            and size * self.data_leak_ratio > 1:
                        self.leak_buffer += data["raw"]
                    else:
                        yield data
                buf = self.leak_buffer
                self.leak_buffer = []
        if buf:
            for data in _handle_buffer(buf):
                yield data
