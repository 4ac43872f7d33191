"""Contrastive losses (counterpart of uniir_tpu/train/losses.py): the
in-batch loss of the CLIP family and BLIP's momentum-distilled loss.

The collator's static flat layout: rows [0, bs) queries, [bs, 2bs)
positives, [2bs, 2bs + bs*neg) hard negatives; with `n_hosts` > 1 the
global batch is host-major, each host's [q|p|n] block after the other.
`bs` is always the global query count, so in-batch negatives span the
whole batch.  Scores and the loss are fp32 (the model returns fp32
embeddings).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) (torch F.normalize semantics, as the JAX package)."""
    return F.normalize(x, dim=dim, eps=eps)


def split_flat_batch(
    embeddings: torch.Tensor, bs: int, hard_neg_num: int = 0, n_hosts: int = 1
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Slice the static flat layout into (q [bs, D], p [bs, D], n [bs, neg, D] or None)."""
    D = embeddings.shape[-1]
    if n_hosts > 1:
        if bs % n_hosts:
            raise ValueError(f"global batch {bs} is not a multiple of {n_hosts} hosts")
        bs_l = bs // n_hosts
        e = embeddings.reshape(n_hosts, (2 + hard_neg_num) * bs_l, D)
        n = e[:, 2 * bs_l :].reshape(bs, hard_neg_num, D) if hard_neg_num > 0 else None
        return e[:, :bs_l].reshape(bs, D), e[:, bs_l : 2 * bs_l].reshape(bs, D), n
    n = embeddings[2 * bs : 2 * bs + bs * hard_neg_num].reshape(bs, hard_neg_num, D) if hard_neg_num > 0 else None
    return embeddings[:bs], embeddings[bs : 2 * bs], n


def inbatch_contrastive_loss(
    embeddings: torch.Tensor,
    bs: int,
    logit_scale: torch.Tensor,
    hard_neg_num: int = 0,
    in_batch_neg_num: int = 0,
    n_hosts: int = 1,
) -> Dict[str, torch.Tensor]:
    """In-batch contrastive CE loss; returns {"loss", "accuracy"} as 0-d tensors.

    Without hard negatives: CE over `q @ p.T * scale` with diagonal targets.
    With hard negatives: NLL of the positive against [pos | hard negatives |
    the first `in_batch_neg_num` positives of the other rows].  As in the JAX
    package (PARITY row 1), row i's in-batch negatives are p_j, j != i: the
    documented intent of the reference, whose expression selects row i's own
    positive bs-1 times.
    """
    q, p, n = split_flat_batch(embeddings, bs, hard_neg_num, n_hosts)
    q, p = l2_normalize(q), l2_normalize(p)

    if hard_neg_num > 0:
        n = l2_normalize(n)
        k = min(bs - 1, in_batch_neg_num)
        if k > 0:
            # first k of [p_j for j != i], in order: skip the diagonal
            j = torch.arange(k, device=p.device)[None, :]
            i = torch.arange(bs, device=p.device)[:, None]
            n = torch.cat([n, p[torch.where(j < i, j, j + 1)]], dim=1)
        pos_scores = (q * p).sum(-1) * logit_scale  # [bs]
        neg_scores = torch.einsum("bd,bkd->bk", q, n) * logit_scale  # [bs, negs]
        logits = torch.cat([pos_scores[:, None], neg_scores], dim=1)
        targets = torch.zeros(bs, dtype=torch.long, device=q.device)
    else:
        logits = (q @ p.T) * logit_scale  # [bs, bs]: global negatives
        targets = torch.arange(bs, device=q.device)
    loss = F.cross_entropy(logits, targets)
    accuracy = (logits.argmax(dim=1) == targets).float().mean()
    return {"loss": loss, "accuracy": accuracy}


def momentum_distill_contrastive_loss(
    embeddings: torch.Tensor,
    embeddings_m: torch.Tensor,
    bs: int,
    p_dids: torch.Tensor,
    queue_query: torch.Tensor,
    queue_cand: torch.Tensor,
    queue_idx: torch.Tensor,
    temp: torch.Tensor,
    alpha,
    hard_neg_num: int = 0,
    n_dids: Optional[torch.Tensor] = None,
    n_hosts: int = 1,
) -> Dict[str, torch.Tensor]:
    """ALBEF-style momentum-distilled symmetric contrastive loss of BLIP
    (reference blip_sf.py:174-313; the JAX package's function of this name).

    `embeddings` are the online model's rows, `embeddings_m` the momentum
    twin's (no gradient); the queues are row-major [Q, D] / [Q].  A candidate
    whose did equals a query's positive did, in the batch or in the queue,
    is a positive too (`pos_idx`).  The soft targets mix the momentum pair's
    softmax (weight `alpha`) with those positives and carry no gradient.
    With hard negatives the first `bs * hard_neg_num` queue rows make way
    for the momentum negatives.  Everything is fp32.  Returns the loss, the
    accuracy (the positive mask at each row's argmax) and the momentum rows
    to enqueue, as in the JAX package."""
    q, p, _ = split_flat_batch(embeddings.float(), bs, hard_neg_num, n_hosts)
    q, p = l2_normalize(q), l2_normalize(p)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=q.device)
    with torch.no_grad():
        q_m, p_m, n_m = split_flat_batch(embeddings_m.float(), bs, hard_neg_num, n_hosts)
        q_m, p_m = l2_normalize(q_m), l2_normalize(p_m)
        if hard_neg_num > 0:
            n_m = l2_normalize(n_m)
            hard = bs * hard_neg_num
            idx_all = torch.cat([p_dids, n_dids.reshape(-1), queue_idx[hard:]])[None, :]
            cand_m_all = torch.cat([p_m, n_m.reshape(hard, -1), queue_cand[hard:]])
        else:
            idx_all = torch.cat([p_dids, queue_idx])[None, :]  # [1, bs + Q]
            cand_m_all = torch.cat([p_m, queue_cand])  # [bs + Q, D]
        query_m_all = torch.cat([q_m, queue_query])  # [bs + Q, D]

        pos_idx = (p_dids.reshape(bs, 1) == idx_all).float()  # [bs, bs + Q]
        sim_targets = pos_idx / pos_idx.sum(dim=1, keepdim=True)
        t = temp.detach()
        sim_q2pc_targets = alpha * torch.softmax(q_m @ cand_m_all.T / t, dim=1) + (1 - alpha) * sim_targets
        sim_pc2q_targets = alpha * torch.softmax(p_m @ query_m_all.T / t, dim=1) + (1 - alpha) * sim_targets

    sim_q2pc = q @ cand_m_all.T / temp
    sim_pc2q = p @ query_m_all.T / temp
    loss_q2pc = -(torch.log_softmax(sim_q2pc, dim=1) * sim_q2pc_targets).sum(dim=1).mean()
    loss_pc2q = -(torch.log_softmax(sim_pc2q, dim=1) * sim_pc2q_targets).sum(dim=1).mean()
    accuracy = pos_idx.gather(1, sim_q2pc.detach().argmax(dim=1, keepdim=True)).mean()
    return {
        "loss": (loss_q2pc + loss_pc2q) / 2,
        "accuracy": accuracy,
        "enqueue_query": q_m,
        "enqueue_pos_cand": p_m,
        "enqueue_neg_cand": n_m[:, 0, :] if hard_neg_num > 0 else None,
    }
