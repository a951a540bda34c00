"""The port's string layer and tfhe_tpu.strings driven in lock step, for the
tests/test_torch_strings*.py files: keys from one seed in both packages,
every encryption made by both client keys in the same order, each op's
output compared word for word (tolerance 0) with its degrees and noise
levels, and every input of the port's op unchanged afterwards (the port's
blocks are tensors that slices and reshapes share, so an op that wrote
into a view of an input would corrupt it)."""

import numpy as np

from tfhe_tpu_torch.ops.torus import to_numpy


def same(ref, port, path="out"):
    """ref (tfhe_tpu) == port (tfhe_tpu_torch), recursively, word for word."""
    if isinstance(ref, (tuple, list)):
        assert isinstance(port, (tuple, list)) and len(ref) == len(port), path
        for i, (r, p) in enumerate(zip(ref, port)):
            same(r, p, f"{path}[{i}]")
        return
    if ref is None or isinstance(ref, (bool, int, str)):
        assert ref == port, (path, ref, port)
        return
    kind = type(ref).__name__
    assert kind == type(port).__name__, (path, kind, type(port).__name__)
    if kind == "FheString":
        assert int(ref.padding) == int(port.padding), (path, "padding")
        same(ref.length, port.length, path + ".length")
        same([c.ct for c in ref.content], [c.ct for c in port.content],
             path + ".content")
    elif kind == "FheSplit":
        same(ref.number_parts, port.number_parts, path + ".number_parts")
        same(ref.parts, port.parts, path + ".parts")
    elif kind == "FheAsciiChar":
        same(ref.ct, port.ct, path)
    elif kind == "ShortintBatch":
        assert np.array_equal(np.asarray(ref.data), to_numpy(port.data)), \
            (path, "data")
        assert np.array_equal(ref.degrees, port.degrees), (path, "degrees")
        assert np.array_equal(ref.noise, port.noise), (path, "noise")
    elif hasattr(ref, "blocks"):
        same(ref.blocks, port.blocks, path)
    else:
        same(ref.block, port.block, path)


def _batches(obj):
    """Every ShortintBatch inside a string-layer value."""
    if isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _batches(o)
    elif type(obj).__name__ == "FheString":
        yield from _batches([c.ct for c in obj.content])
        yield from _batches(obj.length)
    elif type(obj).__name__ == "FheAsciiChar":
        yield from _batches(obj.ct)
    elif type(obj).__name__ == "ShortintBatch":
        yield obj
    elif hasattr(obj, "blocks"):
        yield obj.blocks
    elif hasattr(obj, "block"):
        yield obj.block


def snapshot(args):
    return [(b.data.clone(), b.degrees.copy(), b.noise.copy())
            for b in _batches(args)]


def assert_unchanged(args, snap, name):
    now = list(_batches(args))
    assert len(now) == len(snap), name
    for b, (data, degrees, noise) in zip(now, snap):
        assert b.data.equal(data), (name, "an input's blocks changed")
        assert np.array_equal(b.degrees, degrees), (name, "input degrees")
        assert np.array_equal(b.noise, noise), (name, "input noise")


class StringPair:
    """Both packages' (client key, server key), from one seed."""

    def __init__(self, ref_keys, port_keys):
        self.ref, self.port = ref_keys, port_keys

    def enc(self, fn, *args, rng_seed=None):
        """The same encryption in both packages; rng_seed gives each its
        own random.Random(rng_seed) (random padding)."""
        import random

        kw = {}
        out = []
        for cks in (self.ref[0], self.port[0]):
            if rng_seed is not None:
                kw = {"rng": random.Random(rng_seed)}
            out.append(getattr(cks, fn)(*args, **kw))
        return tuple(out)

    def enc_int(self, v):
        return (self.ref[0].integer_key.encrypt(v),
                self.port[0].integer_key.encrypt(v))

    def op(self, name, *args):
        """sks.name(*args) in both packages (an argument that is a pair is
        split between them); the outputs must match word for word and the
        port's inputs must be unchanged.  Returns the port's output."""
        def side(k):
            return [a[k] if isinstance(a, tuple) else a for a in args]
        ref_out = getattr(self.ref[1], name)(*side(0))
        port_args = side(1)
        snap = snapshot(port_args)
        port_out = getattr(self.port[1], name)(*port_args)
        assert_unchanged(port_args, snap, name)
        same(ref_out, port_out, name)
        return port_out

    def string(self, x):
        return self.port[0].decrypt_string(x)

    def bool(self, x):
        return bool(self.port[0].integer_key.decrypt_bool(x))

    def int(self, x):
        return self.port[0].integer_key.decrypt(x)

    def split(self, x):
        return self.port[0].decrypt_split(x)
