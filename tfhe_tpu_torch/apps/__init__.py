"""Applications layered on the port (port of `tfhe_tpu/apps`): the Trivium
and Kreyvium stream ciphers and transciphering (`apps.trivium`)."""
