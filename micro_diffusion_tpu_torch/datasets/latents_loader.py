"""Train-time loader for precomputed latents, the port's own copy of
micro_diffusion_tpu/datasets/latents_loader.py (``StreamingLatentsDataset`` :30,
``LatentsDataLoader`` :104, ``build_streaming_latents_dataloader`` :260).

Same semantics, batch for batch:
  * one MDS stream per datadir, concatenated into one sample space;
  * per sample: fp16 'caption_latents' -> (1, cap_seq, cap_dim) and fp16
    'latents_<image_size>' -> (C, image_size/8, image_size/8) as 'image_latents';
  * the caption drop ('drop_caption_mask', 0 drops) from a per-(seed, epoch,
    index) numpy generator, so runs reproduce and resume;
  * a deterministic shuffle per (seed, epoch): 'full' (a permutation) or 'block'
    (shuffled contiguous blocks, shuffled inside each), and per-process
    contiguous slices of each global batch;
  * ``state_dict``/``load_state_dict`` capture (epoch, step in epoch) as of the
    last batch the consumer received;
  * a background thread assembles the next numpy batches. Moving them to the
    card is the trainer's job (pinned memory, a side stream).
"""

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

from .mds import MDSReader


class StreamingLatentsDataset:
    """Random-access view over one or more MDS latent datasets."""

    def __init__(self, datadirs: List[str], image_size: int, cap_seq_size: int,
                 cap_emb_dim: int, cap_drop_prob: float = 0.0, seed: int = 18):
        self.readers = [MDSReader(d) for d in datadirs]
        self._cum = np.cumsum([0] + [len(r) for r in self.readers])
        self.image_size = image_size
        self.cap_seq_size = cap_seq_size
        self.cap_emb_dim = cap_emb_dim
        self.cap_drop_prob = cap_drop_prob
        self.seed = seed
        self.latents_key = f"latents_{image_size}"
        self.latent_res = image_size // 8

    def __len__(self) -> int:
        return int(self._cum[-1])

    def get(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        stream = int(np.searchsorted(self._cum, index, side="right")) - 1
        sample = self.readers[stream][index - int(self._cum[stream])]
        return self._postprocess(sample, index, epoch)

    def get_batch(self, indices, epoch: int = 0) -> List[Dict[str, np.ndarray]]:
        """The samples at ``indices``, read stream by stream: one ``read_many``
        each, so a stream's share of a batch goes through the native gather."""
        streams = np.searchsorted(self._cum, indices, side="right") - 1
        out = [None] * len(indices)
        for s in np.unique(streams):
            group = np.flatnonzero(streams == s)
            samples = self.readers[int(s)].read_many(
                [int(indices[g]) - int(self._cum[s]) for g in group])
            for g, sample in zip(group, samples):
                out[int(g)] = self._postprocess(sample, int(indices[g]), epoch)
        return out

    def _postprocess(self, sample, index: int, epoch: int) -> Dict[str, np.ndarray]:
        drop = False
        if self.cap_drop_prob > 0:
            drop = np.random.default_rng((self.seed, epoch, index)).random() < self.cap_drop_prob
        out = {"drop_caption_mask": np.float32(0.0 if drop else 1.0),
               "caption_latents": np.frombuffer(sample["caption_latents"], dtype=np.float16)
               .reshape(1, self.cap_seq_size, self.cap_emb_dim).copy()}
        if self.latents_key in sample:
            out["image_latents"] = (np.frombuffer(sample[self.latents_key], dtype=np.float16)
                                    .reshape(-1, self.latent_res, self.latent_res).copy())
        return out


class LatentsDataLoader:
    """Deterministic, resumable, per-process-partitioned batch iterator."""

    def __init__(self, dataset: StreamingLatentsDataset, batch_size: int,
                 global_batch_size: Optional[int] = None, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 18, process_index: int = 0,
                 process_count: int = 1, prefetch_factor: int = 2,
                 num_epochs: Optional[int] = None, shuffle_algo: str = "full",
                 shuffle_block_size: int = 1 << 18, **_: Any):
        self.dataset = dataset
        self.batch_size = batch_size  # per-process batch
        self.global_batch_size = global_batch_size or batch_size * process_count
        if self.global_batch_size != batch_size * process_count:
            raise ValueError(f"global batch {self.global_batch_size} != {batch_size} x "
                             f"{process_count} processes")
        if shuffle_algo not in ("full", "block"):
            raise ValueError(f"shuffle_algo {shuffle_algo!r}: 'full' or 'block'")
        self.shuffle = shuffle
        self.shuffle_algo = shuffle_algo
        self.shuffle_block_size = shuffle_block_size
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch_factor = max(1, prefetch_factor)
        self.num_epochs = num_epochs
        self._consumed_state = {"epoch": 0, "step_in_epoch": 0}

    def state_dict(self) -> Dict[str, int]:
        """The position as of the last batch the consumer received (prefetched,
        unconsumed batches are not counted, so a resume replays them)."""
        return dict(self._consumed_state)

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self._consumed_state = {"epoch": int(state["epoch"]),
                                "step_in_epoch": int(state["step_in_epoch"])}

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch_size
        return -(-n // self.global_batch_size)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.default_rng((self.seed, epoch))
        if self.shuffle_algo == "full":
            return rng.permutation(n)
        # 'block': the block order is shuffled, then the samples inside each block
        bs = max(1, int(self.shuffle_block_size))
        starts = np.arange(0, n, bs)
        order = np.empty(n, dtype=np.int64)
        pos = 0
        for b in rng.permutation(len(starts)):
            lo = int(starts[b])
            hi = min(n, lo + bs)
            order[pos:pos + hi - lo] = lo + rng.permutation(hi - lo)
            pos += hi - lo
        return order

    def _assemble(self, indices: np.ndarray, epoch: int) -> Dict[str, np.ndarray]:
        samples = self.dataset.get_batch(indices, epoch)
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def _batches(self, epoch: int, start: int) -> Iterator:
        """(state after the batch, batch) from ``start`` steps into ``epoch`` on."""
        while self.num_epochs is None or epoch < self.num_epochs:
            order = self._epoch_order(epoch)
            gbs = self.global_batch_size
            lo = self.process_index * self.batch_size
            for step in range(start, self.steps_per_epoch()):
                mine = order[step * gbs:(step + 1) * gbs][lo:lo + self.batch_size]
                if len(mine) == 0:
                    continue
                yield {"epoch": epoch, "step_in_epoch": step + 1}, self._assemble(mine, epoch)
            epoch, start = epoch + 1, 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Batches assembled by a background thread, ``prefetch_factor`` ahead,
        from the last batch a consumer received (``state_dict()``): batches the
        thread prefetched but nobody took are produced again by the next iterator.
        Closing the iterator early stops the thread."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()
        error: list = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        start = dict(self._consumed_state)

        def producer():
            try:
                for item in self._batches(start["epoch"], start["step_in_epoch"]):
                    if not put(item):
                        return
            except BaseException as e:  # handed to the consumer, which re-raises
                error.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                state, batch = item
                self._consumed_state = state
                yield batch
        finally:
            stop.set()
            thread.join(timeout=10)


def build_streaming_latents_dataloader(datadir: Union[str, List[str]], batch_size: int,
                                       image_size: int = 256, cap_seq_size: int = 77,
                                       cap_emb_dim: int = 1024, cap_drop_prob: float = 0.0,
                                       shuffle: bool = True, drop_last: bool = True,
                                       seed: int = 18, process_index: int = 0,
                                       process_count: int = 1,
                                       **dataloader_kwargs: Any) -> LatentsDataLoader:
    """Reference-signature loader factory (latents_loader.py:73-108); ``batch_size``
    is the per-process batch."""
    if isinstance(datadir, str):
        datadir = [datadir]
    dataset = StreamingLatentsDataset(datadirs=list(datadir), image_size=image_size,
                                      cap_seq_size=cap_seq_size, cap_emb_dim=cap_emb_dim,
                                      cap_drop_prob=cap_drop_prob, seed=seed)
    return LatentsDataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                             drop_last=drop_last, seed=seed, process_index=process_index,
                             process_count=process_count, **dataloader_kwargs)
