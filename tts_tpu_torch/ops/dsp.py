"""Signal helpers (plain PyTorch): the snake activation, STFT / iSTFT,
windows, linear upsampling and the harmonic source's voiced / unvoiced
noise.

Counterparts of the JAX package's `ops/dsp.py` (XLA, no Pallas kernel),
with its conventions (parity: the reference's src/util.cpp:98-217):

  * hann_window(n) = sin^2(pi*i/n), the periodic window;
  * the STFT is centred: the signal is reflect-padded by n_fft//2 on each
    side and frame i starts at i*hop in the padded signal;
  * the iSTFT's output is n_frames*hop long; frame i lands at
    i*hop - n_fft//2 and the sum is divided by the overlap-added window^2.

Angles at the branch cut: a real signal's DC and Nyquist bins are real,
and so is every bin of a frame that is symmetric about its centre (frame
0 always is: the reflect pad and the periodic window are both symmetric
there). An FFT leaves +0 or -0 in those imaginary parts by the order of its
own arithmetic (the JAX package's CPU FFT and torch's differ; cuFFT need
not give an exact zero at all), and atan2 then answers +pi or -pi for a
negative real part. The phase is fed raw into Kokoro's noise convolutions,
so a 2 pi jump is a real difference. `stft` therefore computes the
one-sided DFT (n_fft is 20 for Kokoro) by pairs: x[k] + x[n-k] against the
cosines and x[k] - x[n-k] against the sines, so that a real bin's
imaginary part is an exact zero on every device, and adds +0.0 to both
parts before atan2: a real bin's angle is 0 or +pi, never -pi.
`istft` zeroes the imaginary parts of the DC and Nyquist bins before the
C2R transform, which a C2R transform of a Hermitian spectrum ignores
anyway.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def snake_1d(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha*x)/alpha (arXiv:2006.08195).

    Parity: reference snake_1d src/util.cpp:98-101; alpha broadcasts over
    the channel dim."""
    return x + torch.sin(alpha * x).square() / alpha


def hann_window(n_fft: int, device=None) -> torch.Tensor:
    """Periodic Hann window sin^2(pi*i/n_fft) (src/util.cpp:132), computed
    in float64 on the host and rounded once, as the JAX package does."""
    i = np.arange(n_fft)
    return torch.tensor(np.sin(np.pi * i / n_fft) ** 2, dtype=torch.float32,
                        device=device)


def _overlap_add(frames: torch.Tensor, hop: int, cutoff: int) -> torch.Tensor:
    """Sum frames (..., F, n_fft), frame i placed at i*hop - n_fft//2, into
    (..., cutoff) samples; what falls outside [0, cutoff) is dropped."""
    n_frames, n_fft = frames.shape[-2:]
    lead = frames.shape[:-2]
    length = (n_frames - 1) * hop + n_fft
    cols = frames.reshape(-1, n_frames, n_fft).transpose(1, 2)   # (B, n_fft, F)
    out = F.fold(cols, output_size=(1, length), kernel_size=(1, n_fft),
                 stride=(1, hop))[:, 0, 0]                         # (B, length)
    half = n_fft // 2
    out = out[:, half:half + cutoff]
    if out.shape[-1] < cutoff:
        out = F.pad(out, (0, cutoff - out.shape[-1]))
    return out.reshape(*lead, cutoff)


def window_squared_sum(n_fft: int, hop: int, n_frames: int,
                       window: torch.Tensor) -> torch.Tensor:
    """Overlap-added window^2 normalizer (reference src/util.cpp:203-217):
    n_frames*hop samples from the frames i*hop - n_fft//2 for
    i in [0, n_frames + (n_fft//2)//hop)."""
    total = n_frames + (n_fft // 2) // hop
    w2 = window.square()
    return _overlap_add(w2.expand(total, n_fft), hop, n_frames * hop)


def _frame(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centre-pad (reflect) and cut into overlapping frames:
    (..., T) -> (..., T//hop + 1, n_fft)."""
    half = n_fft // 2
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (half, half), mode="reflect")
    n_frames = x.shape[-1] // hop + 1
    frames = xp[:, 0].unfold(-1, n_fft, hop)[:, :n_frames]
    return frames.reshape(*lead, n_frames, n_fft)


def _real_bins(n_fft: int) -> list:
    """The bins of a real signal's spectrum that are real: DC and, for an
    even n_fft, Nyquist."""
    return [0] + ([n_fft // 2] if n_fft % 2 == 0 else [])


def _rdft_tables(n_fft: int, device):
    """cos / sin of 2 pi k m / n_fft for k in 1 .. (n_fft-1)//2 and the
    one-sided bins m, from the exact angle index (k*m) mod n_fft, with the
    zeros of sin and cos exact."""
    k = np.arange(1, (n_fft - 1) // 2 + 1)[:, None]
    j = (k * np.arange(n_fft // 2 + 1)[None, :]) % n_fft
    c, s = np.cos(2 * np.pi * j / n_fft), np.sin(2 * np.pi * j / n_fft)
    s[(j == 0) | (2 * j == n_fft)] = 0.0
    c[(4 * j == n_fft) | (4 * j == 3 * n_fft)] = 0.0
    return (torch.tensor(c, dtype=torch.float32, device=device),
            torch.tensor(s, dtype=torch.float32, device=device))


def rdft(frames: torch.Tensor, n_fft: int):
    """(real, imaginary) of the one-sided DFT of real frames (..., n_fft),
    computed by pairs (x[k] +- x[n-k]); a bin that is real in exact
    arithmetic has an exact zero imaginary part."""
    cos_t, sin_t = _rdft_tables(n_fft, frames.device)
    n_pairs = cos_t.shape[0]
    lo = frames[..., 1:n_pairs + 1]
    hi = frames[..., n_fft - n_pairs:].flip(-1)
    re = frames[..., :1] + (lo + hi) @ cos_t
    if n_fft % 2 == 0:
        alt = torch.ones(n_fft // 2 + 1, device=frames.device)
        alt[1::2] = -1.0
        re = re + frames[..., n_fft // 2:n_fft // 2 + 1] * alt
    im = -((lo - hi) @ sin_t)
    return re, im


def stft(x: torch.Tensor, window: torch.Tensor, n_fft: int, hop: int,
         abs_and_angle: bool = True) -> torch.Tensor:
    """One-sided short-time Fourier transform of a real signal (..., T) ->
    (..., 2, n_frames, n_fft//2 + 1): (magnitude, atan2 angle) when
    abs_and_angle, else (real, imaginary). Parity: reference `stft`
    src/util.cpp:111-121 (the angle's branch cut: see the module
    docstring)."""
    re, im = rdft(_frame(x, n_fft, hop) * window, n_fft)
    re, im = re + 0.0, im + 0.0
    if abs_and_angle:
        return torch.stack([torch.hypot(re, im), torch.atan2(im, re)], dim=-3)
    return torch.stack([re, im], dim=-3)


def istft(spec: torch.Tensor, window: torch.Tensor, n_fft: int, hop: int,
          abs_and_angle: bool = True,
          win_sq_sum: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse STFT with window-squared-sum normalization. spec (..., 2,
    n_frames, n_bins) one-sided -> (..., n_frames*hop). Parity: reference
    `istft` src/util.cpp:123-130."""
    a, b = spec[..., 0, :, :], spec[..., 1, :, :]
    re, im = (a * torch.cos(b), a * torch.sin(b)) if abs_and_angle else (a, b)
    im = im.clone()
    im[..., _real_bins(n_fft)] = 0.0
    frames = torch.fft.irfft(torch.complex(re.float(), im.float()), n=n_fft,
                             dim=-1) * window
    n_frames = frames.shape[-2]
    out = _overlap_add(frames, hop, n_frames * hop)
    if win_sq_sum is None:
        win_sq_sum = window_squared_sum(n_fft, hop, n_frames, window)
    return out / win_sq_sum


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, correctly rounded on every device. The card divides a tensor
    by a host scalar through the scalar's reciprocal, one ulp off the CPU's
    (and the JAX package's) division; a divisor that lives on the device
    takes the true division."""
    return x / x.new_full((), c)


def upscale_linear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Linear-interpolation upsample along the last axis by an integer
    factor, as torch F.interpolate(mode="linear", align_corners=False),
    which the reference's ggml_upscale_linear replicates
    (src/models/kokoro/model.cpp:175-193). Written out (positions, two
    gathers, a blend) as the JAX package computes it."""
    t = x.shape[-1]
    pos = true_div(torch.arange(t * factor, device=x.device,
                                dtype=torch.float32) + 0.5, factor) - 0.5
    lo = torch.floor(pos).clamp(0, t - 1)
    frac = (pos - lo).clamp(0.0, 1.0)
    lo = lo.long()
    hi = (lo + 1).clamp(max=t - 1)
    return x[..., lo] * (1.0 - frac) + x[..., hi] * frac


def scan_sum(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Running sum along the last axis in float32, in the order XLA's CPU
    backend computes `jnp.cumsum`: blocks of `block` elements summed in
    sequence, the block totals scanned the same way (recursively) and added
    to the next blocks. Every step is a float32 add, so the card and the CPU
    give the same bits, and those of the JAX package on the CPU. (torch's
    own cumsum accumulates in float64 on the CPU and in a float32 parallel
    scan on the card.)"""
    n = x.shape[-1]
    if n <= 1:
        return x.clone()
    nb = -(-n // block)
    blocks = F.pad(x, (0, nb * block - n)).reshape(*x.shape[:-1], nb, block)
    inner = torch.empty_like(blocks)
    acc = blocks[..., 0]
    inner[..., 0] = acc
    for j in range(1, block):
        acc = acc + blocks[..., j]
        inner[..., j] = acc
    if nb > 1:
        carry = scan_sum(inner[..., -1], block)[..., :-1]
        inner[..., 1:, :] += carry[..., None]
    return inner.reshape(*x.shape[:-1], nb * block)[..., :n]


# tanh(x) ~ x * P(x^2) / Q(x^2) on [-c, c] (Eigen's float approximation,
# which XLA's CPU backend emits for float32 tanh, with fused multiply-adds)
_TANH_P = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
           5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
           4.89352455891786e-03)
_TANH_Q = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
           4.89352518554385e-03)
_TANH_CLAMP = 7.99881172180175781
_TANH_LINEAR = 0.0004


def rational_tanh(x: torch.Tensor) -> torch.Tensor:
    """float32 tanh with the bits of the JAX package's on the CPU (XLA's
    rational approximation; tanh(x) = x below 4e-4 in magnitude), on every
    device: the Horner steps are fused multiply-adds, each computed exactly
    in float64 and rounded once to float32, and the rest is float32
    arithmetic, which every device rounds alike. Kokoro's harmonic source
    uses it: its STFT feeds the angles of near-zero bins raw to the noise
    convolutions, so one ulp there moves the waveform."""
    xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = (xc * xc).double()

    def horner(coeffs):
        acc = torch.full_like(x2, coeffs[0]).float()
        for c in coeffs[1:]:
            acc = (x2 * acc.double() + float(np.float32(c))).float()
        return acc

    return torch.where(x.abs() < _TANH_LINEAR, x,
                       (xc * horner(_TANH_P)) / horner(_TANH_Q))


def uv_noise(f0: torch.Tensor, n_harmonics: int, noise: torch.Tensor,
             voice_threshold: float = 10.0, noise_std: float = 0.003,
             sin_amp: float = 0.1) -> tuple[torch.Tensor, torch.Tensor]:
    """Voiced / unvoiced amplitude and noise of the harmonic source
    (reference `uv_noise_compute`, src/util.cpp:140-172): where
    f0 > voice_threshold, uv = sin_amp and noise_out = noise_std * noise;
    elsewhere uv = 0 and noise_out = sin_amp / 3 * noise. `noise`
    (n_harmonics, T) is drawn by the caller. Returns (uv, noise_out)."""
    voiced = (f0 > voice_threshold)[None, :]
    uv = torch.where(voiced, sin_amp, 0.0).to(f0.dtype).expand(n_harmonics, -1)
    noise_out = torch.where(voiced, noise_std * noise, (sin_amp / 3.0) * noise)
    return uv, noise_out

