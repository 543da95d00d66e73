"""The RLHF weight sync of one card (counterpart of
``deepspeed_tpu/runtime/rlhf/sync.py``).

The hybrid engine's train-to-serve handoff copies the live training
parameters, cast to the serving dtype (and LoRA-fused when asked), into the
serving module's tensors in place, and stamps each sync with evidence: the
plan's byte counts, the copy's wall time, and a content digest that the
scheduler re-computes over what it serves after placing a copy, so that
generation N's served weights are shown to be bit-identical to what the
learner published (a scheduler that serves the digested tensors themselves
places nothing and hashes nothing again).
"""

import hashlib
import time
from typing import Dict, Optional, Tuple

import torch


def plan_params_sync(values: Dict[str, torch.Tensor],
                     template: Dict[str, torch.Tensor]) -> dict:
    """The sync's plan summary, with the keys of JAX's ``plan.summary()``
    (``runtime/elastic/planner.py``): ``leaves``, ``total_bytes`` (the bytes
    the copy writes), ``gather_bytes`` and the two meshes' axes, plus
    ``plan_s``. On one card the training and serving tensors live on the
    same device with the same layout, so nothing is gathered
    (``gather_bytes`` 0) and no reshard planner is needed: pricing a move
    between meshes belongs with the elastic planner, a multi-card slice
    of the port (ROADMAP.md Queue A item 8). A name or shape that differs
    from ``template`` is reported as ``{"error": ...}`` (pricing never
    takes the sync down; the copy refuses it)."""
    t0 = time.perf_counter()
    drift = sorted(set(values) ^ set(template))
    drift += [k for k in values if k in template and values[k].shape != template[k].shape]
    if drift:
        out = {"error": f"leaf drift between the training and serving state: {drift[:5]}"}
    else:
        out = {"leaves": len(values),
               "total_bytes": int(sum(t.numel() * t.element_size() for t in template.values())),
               "gather_bytes": 0, "src_axes": {}, "dst_axes": {}}
    out["plan_s"] = time.perf_counter() - t0
    return out


def params_digest(params: Dict[str, torch.Tensor]) -> str:
    """sha256 over every leaf's name, dtype, shape and C-contiguous host
    bytes, in the state dict's order. The learner stamps it beside each
    sync; the scheduler re-digests what it serves after a hot-swap that
    placed a copy."""
    h = hashlib.sha256()
    for name, leaf in params.items():
        host = leaf.detach().cpu().contiguous()
        h.update(name.encode())
        h.update(str(host.dtype).encode())
        h.update(repr(tuple(host.shape)).encode())
        h.update(host.reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


@torch.no_grad()
def execute_params_sync(values: Dict[str, torch.Tensor], template: Dict[str, torch.Tensor],
                        plan_summary: Optional[dict] = None,
                        digest: bool = True) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Copy every leaf of ``values`` into ``template``'s tensor of the same
    name, in place, rounding to its dtype (the cast to the serving dtype is
    part of the copy, with no intermediate tensor), and return
    ``(template, evidence)``. ``evidence``
    holds the plan summary, the copy's wall time (``execute_s``, the card
    synchronized) and, with ``digest``, the content digest (``digest``)
    and its wall time (``digest_s``). Raises ``ValueError`` on drift."""
    bad = sorted(set(values) ^ set(template))
    bad += [k for k in values if k in template and values[k].shape != template[k].shape]
    if bad:
        raise ValueError(f"execute_params_sync: leaf drift {bad[:5]}")
    t0 = time.perf_counter()
    for name, dst in template.items():
        dst.copy_(values[name])
    devices = {t.device for t in template.values() if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    evidence = dict(plan_summary or {})
    evidence["execute_s"] = time.perf_counter() - t0
    if digest:
        t0 = time.perf_counter()
        evidence["digest"] = params_digest(template)
        evidence["digest_s"] = time.perf_counter() - t0
    return template, evidence
