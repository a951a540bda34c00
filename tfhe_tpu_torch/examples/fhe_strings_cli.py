"""CLI timing harness for the homomorphic string library.

Port of `tfhe_tpu/examples/fhe_strings_cli.py`, the counterpart of the
reference's demo binary (ref: tfhe/examples/fhe_strings/main.rs:19-160 +
timing_macros.rs): encrypt a string and a pattern, run the std-string ops
homomorphically, check each result against the clear computation and print
per-op wall times.  The keys live on `--device` (the card unless the caller
passes "cpu").

Usage:
    python -m tfhe_tpu_torch.examples.fhe_strings_cli "Hello World" "World" \
        [--padding 2] [--real-params] [--device cpu]
"""

from __future__ import annotations

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("string")
    ap.add_argument("pattern")
    ap.add_argument("--padding", type=int, default=0,
                    help="random zero padding added at encryption")
    ap.add_argument("--real-params", action="store_true",
                    help="128-bit-secure PARAM_MESSAGE_2_CARRY_2_KS_PBS "
                         "(minutes of keygen) instead of the toy fixture")
    ap.add_argument("--device", default="cuda",
                    help="where the keys and ciphertexts live (default: "
                         "the card; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args()

    from tfhe_tpu_torch import strings

    t0 = time.time()
    if args.real_params:
        cks, sks = strings.gen_keys(device=args.device)
    else:
        cks, sks = strings.gen_keys_test(device=args.device)
    print(f"keygen: {time.time() - t0:.2f}s")

    clear_s, clear_p = args.string, args.pattern
    t0 = time.time()
    if args.padding:
        s = cks.encrypt_str_random_padding(clear_s, args.padding)
    else:
        s = cks.encrypt_str(clear_s)
    pat = cks.encrypt_str(clear_p)
    print(f"encrypt: {time.time() - t0:.2f}s")

    ik = cks.integer_key

    def dec_bool(x):
        return ik.decrypt_bool(x)

    def dec_int(x):
        return ik.decrypt(x) if not isinstance(x, int) else x

    def show(name, fhe_fn, clear_val, dec):
        t = time.time()
        out = fhe_fn()
        dt = time.time() - t
        got = dec(out)
        status = "ok" if got == clear_val else f"MISMATCH (got {got!r})"
        print(f"{name:28s} {dt * 1e3:9.1f} ms   {clear_val!r:<12} {status}")

    print(f"\n{'op':28s} {'time':>9}      clear        check")
    show("eq", lambda: sks.eq(s, pat), clear_s == clear_p, dec_bool)
    show("contains", lambda: sks.contains(s, pat), clear_p in clear_s,
         dec_bool)
    show("starts_with", lambda: sks.starts_with(s, pat),
         clear_s.startswith(clear_p), dec_bool)
    show("ends_with", lambda: sks.ends_with(s, pat),
         clear_s.endswith(clear_p), dec_bool)
    show("len", lambda: sks.len_(s), len(clear_s), dec_int)
    show("is_empty", lambda: sks.is_empty(s), clear_s == "", dec_bool)

    def dec_find(pair):
        found, idx = pair
        return (dec_bool(found), dec_int(idx))

    clear_found = clear_p in clear_s
    clear_idx = clear_s.find(clear_p) if clear_found else 0
    show("find", lambda: sks.find(s, pat), (clear_found, clear_idx),
         dec_find)

    def dec_str(x):
        return cks.decrypt_string(x)

    show("to_uppercase", lambda: sks.to_uppercase(s), clear_s.upper(),
         dec_str)
    show("to_lowercase", lambda: sks.to_lowercase(s), clear_s.lower(),
         dec_str)
    show("trim", lambda: sks.trim(s), clear_s.strip(), dec_str)
    show("concat", lambda: sks.concat(s, pat), clear_s + clear_p, dec_str)
    show("repeat(2)", lambda: sks.repeat(s, 2), clear_s * 2, dec_str)
    show("replace", lambda: sks.replace(s, pat, pat), clear_s.replace(
        clear_p, clear_p), dec_str)

    def dec_split(fs):
        n = dec_int(fs.number_parts)
        return [cks.decrypt_string(p) for p in fs.parts[:n]]

    show("split", lambda: sks.split(s, pat), clear_s.split(clear_p)
         if clear_p else [clear_s], dec_split)


if __name__ == "__main__":
    main()
