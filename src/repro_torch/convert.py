"""Carry data across from the JAX package's objects to the port's.

For the coadd system data takes the place of weights: a survey and its
packed layouts.  These functions read the reference objects only through
their numpy attributes (duck-typed, without importing the JAX package) and
build the port's `Survey` / `PackedDataset`, so a test can feed both
packages the very same arrays.  For the language model, the JAX ``LM.init``
parameter tree (as numpy arrays) becomes the port's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.geometry import WCS
from repro_torch.core.seqfile import PackedDataset
from repro_torch.core.survey import Survey, SurveyConfig, SurveyImage


def _wcs(w) -> WCS:
    return WCS(crval=tuple(w.crval), crpix=tuple(w.crpix),
               cd=(tuple(w.cd[0]), tuple(w.cd[1])))


def survey_from_reference(sv) -> Survey:
    """The port's `Survey` holding the same config, metadata and pixels."""
    cfg = SurveyConfig(**{
        f.name: getattr(sv.config, f.name) for f in dataclasses.fields(SurveyConfig)
    })
    images = [
        SurveyImage(
            image_id=im.image_id,
            run=im.run,
            camcol=im.camcol,
            band_id=im.band_id,
            field=im.field,
            t_obs=im.t_obs,
            wcs=_wcs(im.wcs),
            bounds=tuple(im.bounds),
            pixels=np.asarray(im.pixels, np.float32),
            psf_sigma=im.psf_sigma,
            psf_stamp=None if im.psf_stamp is None else np.asarray(im.psf_stamp, np.float32),
        )
        for im in sv.images
    ]
    return Survey(cfg, images, np.asarray(sv.catalog_ra), np.asarray(sv.catalog_dec),
                  np.asarray(sv.catalog_flux))


def packed_from_reference(ds) -> PackedDataset:
    """The port's `PackedDataset` holding the same containers and index."""
    return PackedDataset(
        layout=ds.layout,
        pixels=np.asarray(ds.pixels, np.float32),
        wcs=np.asarray(ds.wcs, np.float32),
        valid=np.asarray(ds.valid, bool),
        ints={k: np.asarray(v, np.int32) for k, v in ds.ints.items()},
        floats={k: np.asarray(v, np.float32) for k, v in ds.floats.items()},
        pack_band=np.asarray(ds.pack_band, np.int32),
        pack_camcol=np.asarray(ds.pack_camcol, np.int32),
        index={int(k): (int(p), int(s)) for k, (p, s) in ds.index.items()},
        psf_stamps=None if ds.psf_stamps is None else np.asarray(ds.psf_stamps, np.float32),
    )


def lm_params_from_reference(params):
    """The port's `LM` parameters, as CPU tensors, from the JAX package's
    ``LM.init`` tree.

    ``params`` is that tree with numpy (or array-like) leaves, for any
    family: the stacked ``blocks`` (MoE expert stacks included), ``tail``,
    ``cross_blocks`` and ``encoder``, ``shared_attn``, ``ln_enc``, ``embed``
    and ``ln_f``.  Both packages use the same tree, so every leaf keeps its
    path, shape and dtype.
    A caller that wants the card moves the tree there itself.
    """
    if isinstance(params, dict):
        return {k: lm_params_from_reference(v) for k, v in params.items()}
    return torch.from_numpy(np.array(params))


def adamw_state_from_reference(state):
    """The port's AdamW state from the JAX package's ``{"m", "v", "step"}``
    (numpy or array-like leaves): the moments as `lm_params_from_reference`
    carries parameters, ``step`` a 0-d int32 tensor.  CPU tensors."""
    return {"m": lm_params_from_reference(state["m"]), "v": lm_params_from_reference(state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32)}
