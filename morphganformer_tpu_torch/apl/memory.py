"""The episodic memory of APL (port of morphganformer_tpu/apl/memory.py):
a fixed-size ring buffer of (embedding, label) pairs with kNN retrieval by
squared L2 distance (reference apl/memory_store.py).

The state is a dataclass of device tensors and every function returns a
new one, as JAX's pytree does, so an episode of writes and reads runs on
the device with no host read:

- the ring-buffer write is one modular scatter, (pointer + arange(B)) %
  size, the same result as the reference's two-branch slice copy for any
  batch up to the memory's size, wraparound included; a larger batch is
  refused (the reference corrupts its state);
- a read considers the first max(n_neighbours, added) slots (the
  reference's mask_idx), so early in an episode blank slots (zero
  embedding, label n_classes, "unseen") are returned with their true
  distance. Ties go to the lower slot, as `jax.lax.top_k` breaks them.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MemoryState:
    """The episodic memory on one device."""

    embeds: torch.Tensor         # [memory_size, embed_dim] float32
    labels: torch.Tensor         # [memory_size] int32; n_classes is "unseen"
    write_pointer: torch.Tensor  # [] int64, the next slot to write
    added: torch.Tensor          # [] int64, the entries ever written

    @property
    def memory_size(self) -> int:
        return self.embeds.shape[0]

    @property
    def embed_dim(self) -> int:
        return self.embeds.shape[1]

    def replace(self, **kw) -> "MemoryState":
        return dataclasses.replace(self, **kw)


def init_memory(memory_size: int, embed_dim: int, n_classes: int,
                device="cuda") -> MemoryState:
    """A blank memory on `device`: zero embeddings, every label "unseen"
    (n_classes)."""
    return MemoryState(
        embeds=torch.zeros((memory_size, embed_dim), dtype=torch.float32, device=device),
        labels=torch.full((memory_size,), n_classes, dtype=torch.int32, device=device),
        write_pointer=torch.zeros((), dtype=torch.int64, device=device),
        added=torch.zeros((), dtype=torch.int64, device=device),
    )


def flush(state: MemoryState, n_classes: int) -> MemoryState:
    """A blank memory of the same size on the same device (between
    episodes)."""
    return init_memory(state.memory_size, state.embed_dim, n_classes, state.embeds.device)


def add_entries(state: MemoryState, embeds: torch.Tensor, labels: torch.Tensor) -> MemoryState:
    """Write a batch ([batch, embed_dim], [batch]) at the write pointer,
    wrapping around; batch must not exceed memory_size."""
    batch = embeds.shape[0]
    if batch > state.memory_size:
        raise ValueError(f"cannot write {batch} entries into a {state.memory_size}-slot memory")
    idx = (state.write_pointer + torch.arange(batch, device=state.embeds.device)) \
        % state.memory_size
    return state.replace(
        embeds=state.embeds.index_put((idx,), embeds.to(state.embeds.dtype)),
        labels=state.labels.index_put((idx,), labels.to(state.labels.dtype)),
        write_pointer=(state.write_pointer + batch) % state.memory_size,
        added=state.added + batch,
    )


def nearest_entries(state: MemoryState, queries: torch.Tensor, n_neighbours: int):
    """kNN read of `queries` [n_queries, embed_dim]: (embeddings [n_queries,
    n_neighbours, embed_dim], labels [n_queries, n_neighbours], squared
    distances [n_queries, n_neighbours]), nearest first."""
    q = queries.to(torch.float32)
    m = state.embeds
    dist = ((q * q).sum(dim=1, keepdim=True) - 2.0 * (q @ m.T)
            + (m * m).sum(dim=1)[None, :])
    mask_idx = torch.clamp(torch.clamp(state.added, min=n_neighbours), max=state.memory_size)
    invalid = torch.arange(state.memory_size, device=m.device)[None, :] >= mask_idx
    dist = torch.where(invalid, torch.finfo(torch.float32).max / 2, dist)
    top, idx = torch.sort(dist, dim=1, stable=True)
    idx, top = idx[:, :n_neighbours], top[:, :n_neighbours]
    return state.embeds[idx], state.labels[idx], top


def num_entries(state: MemoryState) -> torch.Tensor:
    """The fill level, min(memory_size, added)."""
    return torch.clamp(state.added, max=state.memory_size)
