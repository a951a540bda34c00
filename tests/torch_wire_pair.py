"""The wire format across the two packages: the same bytes for
counterpart objects, and each package loading the other's bytes."""

from tfhe_tpu.utils import serialization as ref_ser

from tfhe_tpu_torch.utils import serialization as ser


def cross(ref_obj, obj):
    """Asserts both packages write the same bytes; returns (the port's
    load of the reference's bytes on the CPU, the reference's load of the
    port's bytes)."""
    ref_bytes = ref_ser.safe_serialize(ref_obj)
    data = ser.safe_serialize(obj)
    assert data == ref_bytes
    return (ser.safe_deserialize(ref_bytes, device="cpu"),
            ref_ser.safe_deserialize(data))
