"""PSF matching and homogenization (the paper deferred it: footnote 2).

Counterpart of ``repro.core.psf``.  Before stacking, frames taken in
different seeing are convolved to one common point-spread function, so the
coadd has a well-defined PSF.  Two banks, one contract:

* **Gaussian-to-Gaussian** (`matching_kernel_bank`): a frame of PSF width
  sigma_i reaches a target sigma_t >= sigma_i by a Gaussian of width
  sqrt(sigma_t^2 - sigma_i^2).  Separable: one (K,) row per slot.
* **Measured-PSF homogenization** (`homogenization_bank`): each frame
  carries an empirical stamp; the matching kernel solving
  ``stamp * k = target`` comes from ridge-regularized least squares in
  Fourier space, cropped to (S, S) taps and renormalized to unit sum.
  Stamps already wider than the target clamp to delta kernels with a
  warning: matching never deconvolves.  One (S, S) kernel per slot.

The banks are solved on the host in numpy float64, with the reference's
own operations, so they are bitwise the reference's.  The device half is
plain torch: `convolve_separable`, `convolve_2d` and `convolve_batch` are
the plain versions of the hand-written ``psf_match`` kernels
(``csrc/psf.cu``), summing their taps in the kernels' order.  Every path
is an edge-clamped cross-correlation:
``out[i, j] = sum_{m,n} k[m, n] * img[clip(i+m-r), clip(j+n-r)]``.
(The reference's ``convolve_separable`` uses ``jnp.convolve``, which
flips the row; it agrees with the correlation only because the Gaussian
rows are symmetric.  Its Pallas kernels and ``convolve_2d`` correlate.)
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch


def gaussian_kernel_1d(sigma: float, radius: Optional[int] = None) -> torch.Tensor:
    """(2r+1,) unit-sum float32 Gaussian row; a (1,) one for sigma <= 0."""
    if sigma <= 0:
        return torch.ones((1,), dtype=torch.float32)
    if radius is None:
        radius = max(1, int(np.ceil(3.0 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def matching_kernel_bank(
    psf_sigmas: np.ndarray, sigma_target: float, radius: Optional[int] = None
) -> np.ndarray:
    """Per-slot 1-D matching kernels: (...,) widths -> (..., K) float32.

    K = 2*radius + 1 is shared by the bank.  Slots at or above the target,
    and empty slots (sigma <= 0), get exact delta rows; empty slots do not
    widen K.
    """
    s = np.asarray(psf_sigmas, np.float64)
    sig_k = np.where(
        s > 0, np.sqrt(np.maximum(sigma_target**2 - s**2, 0.0)), 0.0
    )
    if radius is None:
        radius = int(np.ceil(3.0 * float(sig_k.max(initial=0.0))))
    k_width = 2 * radius + 1
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    delta = (x == 0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.exp(-0.5 * (x / np.where(sig_k == 0, 1.0, sig_k)[..., None]) ** 2)
    bank = np.where((sig_k > 0)[..., None], g, delta)
    bank = bank / bank.sum(axis=-1, keepdims=True)
    assert bank.shape == s.shape + (k_width,)
    return bank.astype(np.float32)


def gaussian_stamp(sigma: float, size: int) -> np.ndarray:
    """(size, size) unit-sum circular Gaussian: the homogenization target."""
    if size % 2 == 0:
        raise ValueError(f"stamp size must be odd, got {size}")
    c = (size - 1) / 2.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    g = np.exp(-0.5 * ((xx - c) ** 2 + (yy - c) ** 2) / max(sigma, 1e-6) ** 2)
    return (g / g.sum()).astype(np.float64)


def stamp_sigma(stamps: np.ndarray) -> np.ndarray:
    """Gaussian-equivalent width sqrt(<r^2>/2) per (..., S, S) stamp.

    Exact for a Gaussian; zero-sum (empty-slot) stamps report 0.
    """
    s = np.asarray(stamps, np.float64)
    size = s.shape[-1]
    c = (size - 1) / 2.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    r2 = (xx - c) ** 2 + (yy - c) ** 2
    tot = s.sum(axis=(-2, -1))
    mom = (s * r2).sum(axis=(-2, -1))
    with np.errstate(divide="ignore", invalid="ignore"):
        sig = np.sqrt(np.maximum(mom / np.where(tot == 0, 1.0, tot), 0.0) / 2.0)
    return np.where(tot > 0, sig, 0.0)


def _delta_stamp(size: int) -> np.ndarray:
    d = np.zeros((size, size), np.float64)
    d[(size - 1) // 2, (size - 1) // 2] = 1.0
    return d


def homogenization_kernel(
    stamp: np.ndarray, target: np.ndarray, ridge: float = 1e-6
) -> np.ndarray:
    """Solve ``stamp * k = target`` for one (S, S) matching kernel.

    K = conj(S) T / (|S|^2 + lam), lam = ridge * max|S|^2, on the
    (2S-1)-point linear-convolution grid; cropped to S x S, flipped into
    correlation taps and normalized to unit sum (a delta if the sum
    vanishes).  The readable single-stamp form of `homogenization_bank`.
    """
    s = np.asarray(stamp, np.float64)
    t = np.asarray(target, np.float64)
    size = s.shape[-1]
    n = 2 * size - 1
    s_hat = np.fft.fft2(np.fft.ifftshift(_center_embed(s, n)))
    t_hat = np.fft.fft2(np.fft.ifftshift(_center_embed(t, n)))
    power = np.abs(s_hat) ** 2
    lam = ridge * power.max()
    k_hat = np.conj(s_hat) * t_hat / (power + lam)
    k_full = np.fft.fftshift(np.fft.ifft2(k_hat).real)
    lo = (n - size) // 2
    k = k_full[lo : lo + size, lo : lo + size]
    k = k[::-1, ::-1]  # convolution solve -> correlation-convention taps
    tot = k.sum()
    if abs(tot) < 1e-8:
        return _delta_stamp(size)
    return k / tot


def _center_embed(stamp: np.ndarray, n: int) -> np.ndarray:
    """Place an (S, S) stamp at the center of an (n, n) zero canvas."""
    size = stamp.shape[-1]
    out = np.zeros((n, n), np.float64)
    lo = (n - size) // 2
    out[lo : lo + size, lo : lo + size] = stamp
    return out


def homogenization_bank(
    stamps: np.ndarray,
    psf_sigmas: np.ndarray,
    sigma_target: float,
    ridge: float = 1e-6,
    clamp_tol: float = 1.02,
) -> np.ndarray:
    """Per-slot 2-D matching kernels from measured stamps.

    ``stamps`` is (..., S, S), any leading slot shape (e.g. a layout's
    (P, cap)); the result is (..., S, S) float32.  Empty slots
    (``psf_sigmas <= 0`` or zero-sum stamps) get exact delta kernels, and so
    do stamps wider than ``clamp_tol`` times the target's width, with one
    RuntimeWarning that counts them: matching never deconvolves.
    """
    s = np.asarray(stamps, np.float64)
    if s.shape[-1] != s.shape[-2] or s.shape[-1] % 2 == 0:
        raise ValueError(f"stamps must be odd square, got {s.shape[-2:]}")
    size = s.shape[-1]
    lead = s.shape[:-2]
    sig = np.asarray(psf_sigmas, np.float64).reshape(-1)
    flat = s.reshape((-1, size, size))
    target = gaussian_stamp(sigma_target, size)
    delta = _delta_stamp(size)
    widths = stamp_sigma(flat)
    empty = (sig <= 0) | (flat.sum(axis=(-2, -1)) <= 0)
    too_wide = ~empty & (widths > clamp_tol * float(stamp_sigma(target)))
    out = np.broadcast_to(delta, flat.shape).copy()
    ok = ~(empty | too_wide)
    if ok.any():
        # `homogenization_kernel` batched: one FFT call over the live slots.
        n = 2 * size - 1
        lo = (n - size) // 2
        emb = np.zeros((int(ok.sum()), n, n), np.float64)
        emb[:, lo : lo + size, lo : lo + size] = flat[ok]
        s_hat = np.fft.fft2(np.fft.ifftshift(emb, axes=(-2, -1)))
        t_hat = np.fft.fft2(np.fft.ifftshift(_center_embed(target, n)))
        power = np.abs(s_hat) ** 2
        lam = ridge * power.max(axis=(-2, -1), keepdims=True)
        k_hat = np.conj(s_hat) * t_hat[None] / (power + lam)
        k_full = np.fft.fftshift(np.fft.ifft2(k_hat).real, axes=(-2, -1))
        k = k_full[:, lo : lo + size, lo : lo + size][:, ::-1, ::-1]
        tot = k.sum(axis=(-2, -1), keepdims=True)
        k = np.where(np.abs(tot) < 1e-8, delta, k / np.where(tot == 0, 1.0, tot))
        out[ok] = k
    if too_wide.any():
        warnings.warn(
            f"homogenization_bank: {int(too_wide.sum())}/{len(flat)} stamps "
            f"wider than target sigma={sigma_target}; clamped to delta "
            "(matching never deconvolves)",
            RuntimeWarning,
            stacklevel=2,
        )
    return out.reshape(lead + (size, size)).astype(np.float32)


# ----- device half: the plain versions of the psf_match kernels -----

def _edge_pad(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Pad ``x`` by ``r`` copies of its edge on both sides of ``dim``:
    padded[p] == x[clip(p - r, 0, n - 1)], for any n >= 1."""
    if r == 0:
        return x
    first = x.narrow(dim, 0, 1)
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    reps = [1] * x.dim()
    reps[dim] = r
    return torch.cat([first.repeat(reps), x, last.repeat(reps)], dim)


def _taps(kernels: torch.Tensor, *index) -> torch.Tensor:
    """One tap per image of an (N, ...) bank, shaped to broadcast on (N, H, W)."""
    return kernels[(slice(None),) + index].reshape(-1, 1, 1)


def _correlate_axis(images: torch.Tensor, rows: torch.Tensor, dim: int) -> torch.Tensor:
    """(N, H, W) images correlated along ``dim`` with per-image (N, K) rows,
    edge-clamped; the taps summed in order m = 0..K-1 from zero."""
    k = rows.shape[-1]
    n = images.shape[dim]
    padded = _edge_pad(images, (k - 1) // 2, dim)
    out = torch.zeros_like(images)
    for m in range(k):
        out = out + _taps(rows, m) * padded.narrow(dim, m, n)
    return out


def _separable_batch(images: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Row pass along W, then column pass along H (``_convolve_sep_matmul``)."""
    return _correlate_axis(_correlate_axis(images, rows, 2), rows, 1)


def _correlate_2d_batch(images: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """(N, H, W) images correlated with per-image (N, Kh, Kw) taps, edge-clamped.

    For each kernel row m the taps n = 0..Kw-1 are summed from zero, and the
    row sums are added to the output in order m = 0..Kh-1, as
    ``_convolve_2d_matmul`` adds its Kh banded-matmul pairs.
    """
    kh, kw = kernels.shape[-2:]
    h, w = images.shape[-2:]
    padded = _edge_pad(_edge_pad(images, (kh - 1) // 2, 1), (kw - 1) // 2, 2)
    out = torch.zeros_like(images)
    for m in range(kh):
        band = padded[:, m : m + h]
        row = torch.zeros_like(images)
        for n in range(kw):
            row = row + _taps(kernels, m, n) * band[:, :, n : n + w]
        out = out + row
    return out


def convolve_separable(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """(H, W) image correlated with one (K,) row along both axes, edge-clamped."""
    return _separable_batch(image[None], kernel[None])[0]


def convolve_2d(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """(H, W) image correlated with one (Kh, Kw) kernel, edge-clamped."""
    return _correlate_2d_batch(image[None], kernel[None])[0]


def convolve_batch(images: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """(N, H, W) images, each correlated with its own kernel of the bank.

    Dispatches on bank rank: (N, K) rows apply separably, (N, Kh, Kw) taps
    as a full 2-D correlation.  K == 1 (Kw == 1 for a 2-D bank)
    short-circuits to one multiply by the (first) tap, as the reference's
    ``convolve_batch`` does.
    """
    if kernels.dim() == images.dim():
        if kernels.shape[-1] == 1:
            return images * kernels[:, 0, 0].reshape(-1, 1, 1)
        return _correlate_2d_batch(images, kernels)
    if kernels.shape[-1] == 1:
        return images * kernels[:, 0].reshape(-1, 1, 1)
    return _separable_batch(images, kernels)


def match_psf(image: torch.Tensor, sigma_image: float, sigma_target: float) -> torch.Tensor:
    """Convolve one image to the target PSF; the same object if already as wide."""
    if sigma_target <= sigma_image:
        return image
    sigma_k = float(np.sqrt(sigma_target**2 - sigma_image**2))
    return convolve_separable(image, gaussian_kernel_1d(sigma_k).to(image.device))
