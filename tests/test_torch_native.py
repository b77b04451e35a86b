"""The port's native MDS gather (datasets/native.py, _native/mds_gather.cpp) against
the JAX package's: the raw gather bitwise, ``MDSReader.read_many`` sample for sample
on a set the JAX ``MDSWriter`` wrote, the latents loader through the gather against
the memmap path and the JAX loader; the errors (a missing file, a failed build, which
raises instead of falling back), where the library lands, builds racing in four
processes, and that the module loads no JAX."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from micro_diffusion_tpu.datasets import MDSWriter as JMDSWriter
from micro_diffusion_tpu.datasets import latents_loader as jloader
from micro_diffusion_tpu.datasets import mds as jmds
from micro_diffusion_tpu.datasets import native as jnative
from micro_diffusion_tpu_torch.datasets import latents_loader as tloader
from micro_diffusion_tpu_torch.datasets import mds as tmds
from micro_diffusion_tpu_torch.datasets import native as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 8  # latent resolution of the loader set (image_size 64)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """200 samples over several shards, written by the JAX writer: a variable-size
    bytes column, a string and a fixed-size int."""
    d = tmp_path_factory.mktemp("native") / "ds"
    rng = np.random.default_rng(0)
    with JMDSWriter(out=str(d), columns={"payload": "bytes", "name": "str", "k": "int"},
                    size_limit=40_000) as w:
        for i in range(200):
            w.write({"payload": rng.bytes(300 + 7 * i), "name": f"sample {i}", "k": i})
    return str(d)


@pytest.fixture(scope="module")
def latents(tmp_path_factory):
    """A latents set in the recipe's columns, over several shards."""
    d = tmp_path_factory.mktemp("native") / "latents"
    rng = np.random.default_rng(1)
    with JMDSWriter(out=str(d), columns={"caption_latents": "bytes",
                                         f"latents_{8 * RES}": "bytes"},
                    size_limit=200_000) as w:
        for _ in range(40):
            w.write({"caption_latents": rng.standard_normal((1, 77, 1024))
                     .astype(np.float16).tobytes(),
                     f"latents_{8 * RES}": rng.standard_normal((4, RES, RES))
                     .astype(np.float16).tobytes()})
    return str(d)


def test_gather_matches_jax_bitwise(dataset):
    """The same byte ranges (duplicates, across shards, one empty) through both
    libraries: the same bytes, the port's as views of its one buffer."""
    r = jmds.MDSReader(dataset)
    assert len(r.shards) > 3
    ranges = [r.sample_range(i) for i in (3, 77, 150, 199, 0, 77, 64, 120)]
    paths = [p for p, _, _, _ in ranges]
    offs = [b for _, _, b, _ in ranges]
    lens = [n for _, _, _, n in ranges]
    lens[-1] = 0
    got = tnative.gather(paths, offs, lens, num_threads=3)
    assert got == jnative.gather(paths, offs, lens)
    # read-only views of one buffer: no second copy of a blob
    assert all(isinstance(g, memoryview) and g.readonly and g.obj is got[0].obj for g in got)
    assert got[:-1] == [r._shard_data(s)[b:b + n].tobytes() for _, s, b, n in ranges[:-1]]
    assert got[-1] == b"" and tnative.gather([], [], []) == []


@pytest.mark.parametrize("n", [1, 3, 4, 64])
def test_read_many_matches_jax(dataset, monkeypatch, n):
    """read_many sample for sample against JAX's; the native gather reads the
    batches of 4 or more and only those."""
    idx = np.random.default_rng(n).integers(0, 200, n).tolist()
    calls = []
    gather = tnative.gather
    monkeypatch.setattr(tnative, "gather", lambda *a, **k: calls.append(len(a[0])) or
                        gather(*a, **k))
    reader = tmds.MDSReader(dataset)
    got = reader.read_many(idx)
    assert got == jmds.MDSReader(dataset).read_many(idx)
    assert got == [reader[i] for i in idx]
    assert [s["k"] for s in got] == idx
    assert calls == ([n] if n >= tmds.NATIVE_MIN_BATCH else [])
    assert reader.sample_range(idx[0]) == jmds.MDSReader(dataset).sample_range(idx[0])


def test_loader_gather_equals_memmap_and_jax(latents, monkeypatch):
    """The loader's batches (per-rank batch 8, two ranks, over an epoch boundary)
    through the gather are bitwise those of the memmap path and of the JAX loader."""
    kw = dict(datadir=latents, batch_size=8, image_size=8 * RES, cap_drop_prob=0.5,
              seed=5, process_count=2)

    def batches(module, rank):
        loader = module.build_streaming_latents_dataloader(process_index=rank, **kw)
        it = iter(loader)
        out = [next(it) for _ in range(4)]  # 2 steps an epoch: crosses it once
        it.close()
        return out

    for rank in (0, 1):
        native = batches(tloader, rank)
        ref = batches(jloader, rank)
        with monkeypatch.context() as m:
            m.setattr(tmds, "NATIVE_MIN_BATCH", 10**9)
            m.setattr(tnative, "gather", None)  # the memmap path must not call it
            plain = batches(tloader, rank)
        for a, b, c in zip(native, plain, ref):
            assert a.keys() == b.keys() == c.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype == c[k].dtype, k
                assert np.array_equal(a[k], b[k]) and np.array_equal(a[k], c[k]), k


def test_missing_file_raises_oserror(dataset):
    with pytest.raises(OSError):
        tnative.gather(["/nonexistent/shard.00000.mds"], [0], [10])
    path = tmds.MDSReader(dataset).sample_range(0)[0]
    with pytest.raises(OSError):  # a read past the end of the file
        tnative.gather([path], [os.path.getsize(path) - 4], [64])


def test_library_lands_in_the_package_build_dir():
    assert tnative.available()
    path = tnative.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "micro_diffusion_tpu_torch", "_build")
    assert os.path.isfile(path) and os.path.basename(path).startswith("mds_gather-")


@pytest.mark.parametrize("compiler", ["no-such-compiler-mdt", "false"])
def test_failed_build_raises(tmp_path, dataset, monkeypatch, compiler):
    """An unknown compiler, or one that fails: the build raises, no library is
    left behind, and read_many raises instead of falling back to the memmaps."""
    with pytest.raises(RuntimeError, match="failed"):
        tnative.build(compiler=compiler, build_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []
    build = tnative.build
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "build", lambda: build(compiler=compiler,
                                                        build_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="failed"):
        tmds.MDSReader(dataset).read_many(range(tmds.NATIVE_MIN_BATCH))


def test_concurrent_builds_and_gathers(tmp_path, dataset):
    """Four processes build into one empty directory at once (the four ranks of one
    host): each loads a whole library and gathers the right bytes; then 8 threads
    of this process gather at once."""
    code = ("import sys\n"
            "from micro_diffusion_tpu_torch.datasets import native, mds\n"
            "native.build = lambda b=native.build: b(build_dir=sys.argv[1])\n"
            "r = mds.MDSReader(sys.argv[2])\n"
            "idx = list(range(0, 200, 9))\n"
            "assert r.read_many(idx) == [r[i] for i in idx]\n"
            "print(native.library_path(sys.argv[1]))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path), dataset],
                              cwd=ROOT, stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0] * 4
    assert len(set(outs)) == 1 and os.listdir(tmp_path) == [os.path.basename(outs[0])]

    reader = tmds.MDSReader(dataset)
    want = [reader[i] for i in range(200)]
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        for _ in range(20):
            idx = rng.integers(0, 200, 32).tolist()
            if reader.read_many(idx) != [want[i] for i in idx]:
                errors.append(seed)

    threads = [threading.Thread(target=work, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and errors == []


def test_no_jax_in_a_fresh_interpreter(dataset):
    code = ("import sys\n"
            "from micro_diffusion_tpu_torch.datasets import mds, native\n"
            "assert len(mds.MDSReader(sys.argv[1]).read_many(range(8))) == 8\n"
            "bad = [n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'flax', 'micro_diffusion_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code, dataset], check=True, timeout=120, cwd=ROOT)
