"""Audio feature extraction: log-mel fbank + CMVN + LFR stacking (a copy
of the JAX package's ``data/audio.py``, which is host numpy and needs no
JAX; the port keeps its own so that it imports nothing of that package).

The reference's audio path (SBL_Multilingual_Lip_reading/utils.py:199-233
``extract_feature`` and data_gen_LRW.py:88-102 ``build_LFR_features``)
without librosa: STFT through numpy's FFT, a Slaney-style mel filterbank,
log compression ``log(mel + 1e-6)``, per-dim CMVN, [-0.5, 0.5] peak
normalization, and an energy-based trim in place of
``librosa.effects.trim(top_db=20)``.

Defaults match the reference: sr 16000, 80 mel bins, 25 ms windows, 10 ms
hop; LFR stacks m=4 frames every n=3.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def peak_normalize(y: np.ndarray) -> np.ndarray:
    """Scale/shift into [-0.5, 0.5] (reference utils.py:176-184)."""
    ymax, ymin = np.max(y), np.min(y)
    if ymax == ymin:
        return np.zeros_like(y)
    a = 1.0 / (ymax - ymin)
    b = -(ymax + ymin) / (2.0 * (ymax - ymin))
    return y * a + b


def energy_trim(y: np.ndarray, sr: int = 16000, top_db: float = 20.0,
                frame: int = 512, hop: int = 128) -> np.ndarray:
    """Trim leading/trailing silence below max_dB - top_db (equivalent of
    librosa.effects.trim)."""
    if len(y) < frame:
        return y
    n = 1 + (len(y) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    rms = np.sqrt(np.mean(y[idx] ** 2, axis=1) + 1e-12)
    db = 20.0 * np.log10(rms + 1e-12)
    keep = np.nonzero(db > db.max() - top_db)[0]
    if len(keep) == 0:
        return y
    start = keep[0] * hop
    end = min(len(y), keep[-1] * hop + frame)
    return y[start:end]


def hz_to_mel(f):
    """Slaney mel scale (librosa default)."""
    f = np.asarray(f, dtype=np.float64)
    mel = 3.0 * f / 200.0
    log_region = f >= 1000.0
    mel = np.where(log_region,
                   15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
                   mel)
    return mel


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = 200.0 * m / 3.0
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
    return f


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular Slaney-normalized filterbank."""
    fmax = sr / 2.0
    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.linspace(0, fmax, 1 + n_fft // 2)
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = (fft_freqs - freqs[i]) / max(freqs[i + 1] - freqs[i], 1e-10)
        upper = (freqs[i + 2] - fft_freqs) / max(freqs[i + 2] - freqs[i + 1], 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(lower, upper))
        enorm = 2.0 / (freqs[i + 2] - freqs[i])
        fb[i] *= enorm
    return fb.astype(np.float32)


def stft_power(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """(frames, 1 + n_fft//2) power spectrogram, centered hann frames."""
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect" if len(y) > pad else "constant")
    n = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
    frames = y[idx] * np.hanning(n_fft)[None, :]
    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    return (np.abs(spec) ** 2).astype(np.float32)


def extract_fbank(y: np.ndarray, sr: int = 16000, dim: int = 80,
                  cmvn: bool = True, window_ms: int = 25,
                  stride_ms: int = 10, trim: bool = True) -> np.ndarray:
    """Waveform -> (T, dim) log-mel features (reference extract_feature)."""
    if trim:
        y = energy_trim(y, sr)
    y = peak_normalize(y)
    ws = int(sr * 0.001 * window_ms)
    st = int(sr * 0.001 * stride_ms)
    power = stft_power(y, ws, st)
    fb = mel_filterbank(sr, ws, dim)
    mel = power @ fb.T                       # (T, dim)
    feat = np.log(mel + 1e-6)
    if cmvn:
        mu = feat.mean(axis=0, keepdims=True)
        sd = feat.std(axis=0, keepdims=True) + 1e-16
        feat = (feat - mu) / sd
    return feat.astype(np.float32)


def extract_mfcc(y: np.ndarray, sr: int = 16000, n_mfcc: int = 80,
                 n_mels: int = 26, window_ms: int = 25, stride_ms: int = 10,
                 trim: bool = True) -> np.ndarray:
    """Waveform -> (T, n_mfcc) MFCCs via DCT-II of the log-mel spectrogram
    (the reference's feature='mfcc' branch, utils.py:213-216; its cepstral-0
    RMS substitution is omitted -- dead code in the reference)."""
    if trim:
        y = energy_trim(y, sr)
    y = peak_normalize(y)
    ws = int(sr * 0.001 * window_ms)
    st = int(sr * 0.001 * stride_ms)
    power = stft_power(y, ws, st)
    fb = mel_filterbank(sr, ws, n_mels)
    logmel = np.log(power @ fb.T + 1e-6)          # (T, n_mels)
    k = np.arange(n_mfcc)[:, None]
    n = np.arange(n_mels)[None, :]
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k) * np.sqrt(2.0 / n_mels)
    dct[0] *= 1.0 / np.sqrt(2.0)                  # ortho norm
    return (logmel @ dct.T).astype(np.float32)


def build_lfr_features(inputs: np.ndarray, m: int = 4, n: int = 3
                       ) -> np.ndarray:
    """Low-frame-rate stacking: concat m frames, hop n (reference
    data_gen_LRW.py:88-102).  Tail windows repeat the last frame."""
    T, d = inputs.shape
    n_lfr = int(np.ceil(T / n))
    out = np.zeros((n_lfr, m * d), dtype=inputs.dtype)
    for i in range(n_lfr):
        s = i * n
        if s + m <= T:
            out[i] = inputs[s:s + m].reshape(-1)
        else:
            chunk = inputs[s:]
            pad = np.repeat(inputs[-1:], m - len(chunk), axis=0)
            out[i] = np.concatenate([chunk, pad], axis=0).reshape(-1)
    return out
