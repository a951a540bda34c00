"""Entries: how a traffic mix's requests reach the program.  A traffic file
names its entry; `benchmark/entries/<entry>.py` defines `Entry` with
`keygen`, `prepare`, `make`, `submit`, `answer`, `kind`, `ops` and
`close` (see api_ops.py)."""
