"""Checkpoint / resume of OO-VQE optimization state.

Port of auto_oo_tpu/utils/checkpoint.py, in the same ``.npz`` format
(version 2): theta, oao_mo_coeff, an optional energy, a problem-spec
header (ncas, nelecas, basis, ansatz, nao) checked on resume, and extra
arrays.  A checkpoint written by either package resumes in the other,
which is how a Berry loop's warm start crosses processes and packages.
Tensors are saved from the host; ``resume`` puts oao_mo_coeff and theta
on the OO_pqc's device.
"""

import warnings

import numpy as np
import torch

from .misc import to_numpy

CHECKPOINT_VERSION = 2

_SPEC_KEYS = ("ncas", "nelecas", "basis", "ansatz", "nao")


def _spec_of(oo_pqc):
    """Problem-spec header fields of an OO_pqc/OO_energy."""
    pqc = getattr(oo_pqc, "pqc", None)
    nelecas = getattr(oo_pqc, "nelecas", None)
    if isinstance(nelecas, (tuple, list)):
        nelecas = f"{nelecas[0]},{nelecas[1]}"
    ansatz = getattr(pqc, "ansatz", None)
    if ansatz is not None and not isinstance(ansatz, str):
        ansatz = type(ansatz).__name__
    return {
        "ncas": getattr(oo_pqc, "ncas", None),
        "nelecas": nelecas,
        "basis": getattr(oo_pqc, "basis", None),
        "ansatz": ansatz,
        "nao": getattr(oo_pqc, "nao", None),
    }


def save_state(path, theta, oao_mo_coeff, energy=None, extra=None,
               spec=None, oo_pqc=None):
    """Persist an optimization state.  ``extra`` is a dict of additional
    arrays (e.g. trajectories).  Pass ``oo_pqc`` (or an explicit ``spec``
    dict with ncas/nelecas/basis/ansatz/nao) to embed a problem-spec
    header that ``resume`` checks."""
    payload = {
        "version": np.asarray(CHECKPOINT_VERSION),
        "theta": to_numpy(theta),
        "oao_mo_coeff": to_numpy(oao_mo_coeff),
    }
    if energy is not None:
        payload["energy"] = to_numpy(energy)
    if oo_pqc is not None and spec is None:
        spec = _spec_of(oo_pqc)
    if spec:
        for k in _SPEC_KEYS:
            if spec.get(k) is not None:
                payload[f"spec_{k}"] = np.asarray(str(spec[k]))
    if extra:
        for k, v in extra.items():
            payload[f"extra_{k}"] = to_numpy(v)
    np.savez(path, **payload)


def load_state(path):
    """Load a checkpoint: a dict with theta, oao_mo_coeff, energy
    (optional), spec (possibly empty) and extra, as numpy arrays."""
    with np.load(path, allow_pickle=False) as data:
        version = int(data["version"])
        if version > CHECKPOINT_VERSION:
            raise ValueError(f"checkpoint version {version} is newer than "
                             f"supported {CHECKPOINT_VERSION}")
        out = {"theta": data["theta"],
               "oao_mo_coeff": data["oao_mo_coeff"]}
        if "energy" in data:
            out["energy"] = data["energy"]
        out["spec"] = {k[len("spec_"):]: str(data[k]) for k in data.files
                       if k.startswith("spec_")}
        out["extra"] = {k[len("extra_"):]: data[k] for k in data.files
                        if k.startswith("extra_")}
    return out


def resume(oo_pqc, path, strict=True):
    """Apply a checkpoint to an OO_pqc/OO_energy: sets its oao_mo_coeff on
    its device and returns theta there (the cross-process twin of the
    in-memory warm start).  Every field of the checkpoint's spec header
    must match the target problem; a mismatch raises ValueError, or warns
    with ``strict=False`` (a deliberate cross-problem transfer)."""
    state = load_state(path)
    saved = state.get("spec") or {}
    if saved:
        current = {k: str(v) for k, v in _spec_of(oo_pqc).items()
                   if v is not None}
        mismatches = [
            f"{k}: checkpoint={saved[k]!r} target={current[k]!r}"
            for k in saved if k in current and saved[k] != current[k]]
        if mismatches:
            msg = ("checkpoint problem spec does not match the target "
                   "problem — " + "; ".join(mismatches))
            if strict:
                raise ValueError(msg)
            warnings.warn(msg, stacklevel=2)
    device = oo_pqc.device
    oo_pqc.oao_mo_coeff = torch.as_tensor(state["oao_mo_coeff"],
                                          dtype=torch.float64, device=device)
    return torch.as_tensor(state["theta"], dtype=torch.float64,
                           device=device)
