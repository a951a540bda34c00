"""The plain reference the benchmark judges the program by: LWE keys,
encryption and decryption for the benchmark's own inputs (`lwe`), and the
clear functions the ops compute, with the lower-precision control beside
them (`clear`).  Plain PyTorch and the standard library: nothing here
imports the program under test, and nothing takes what it made."""
