"""The port's high-level API (tfhe_tpu_torch.api, on the CPU) and
tfhe_tpu.api driven in lock step, for the tests/test_torch_api*.py files:
keys from one seed in both packages, every encryption made by both client
keys in the same order, and every result's blocks compared word for word
(tolerance 0), with their degrees and noise levels, before the port's
result is decrypted (torch_integer_pair.same).  Both packages' server keys
are set in the calling thread."""

import tfhe_tpu.api as ref_api

import tfhe_tpu_torch.api as api
from torch_integer_pair import same


def make_pair(ref_params, params, seed, fused=False):
    ref_cks, ref_sks = ref_api.generate_keys(
        ref_api.ConfigBuilder.default().use_custom_parameters(
            ref_params).build(), seed=seed)
    cks, sks = api.generate_keys(
        api.ConfigBuilder.default().use_custom_parameters(params).build(),
        seed=seed, device="cpu", fused=fused)
    pair = ApiPair((ref_cks, ref_sks), (cks, sks))
    pair.set_keys()
    return pair


class ApiPair:
    """Both packages' (ClientKey, ServerKey), made from one seed."""

    def __init__(self, ref_keys, port_keys):
        self.ref, self.port = ref_keys, port_keys

    def set_keys(self):
        ref_api.set_server_key(self.ref[1])
        api.set_server_key(self.port[1])

    def enc(self, type_name, value):
        """`type_name`.encrypt(value) in both packages."""
        return (getattr(ref_api, type_name).encrypt(value, self.ref[0]),
                getattr(api, type_name).encrypt(value, self.port[0]))

    def trivial(self, type_name, value):
        return (getattr(ref_api, type_name).encrypt_trivial(value),
                getattr(api, type_name).encrypt_trivial(value))

    @staticmethod
    def run(fn, *args):
        """fn(*args) in both packages; an argument that is a pair is split
        between them."""
        def side(k):
            return [a[k] if isinstance(a, tuple) else a for a in args]
        return fn(*side(0)), fn(*side(1))

    def dec(self, pair):
        """The port's decryption, after checking that both packages hold
        the same blocks, degrees and noise levels and the same type."""
        ref_v, port_v = pair
        assert type(ref_v).__name__ == type(port_v).__name__
        same(ref_v.inner, port_v.inner)
        return port_v.decrypt(self.port[0])
