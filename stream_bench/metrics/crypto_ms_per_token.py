"""Gateway and relay: wall ms inside the relay's AES-GCM envelope calls
(encrypt on the producer side, decrypt on the consumer side) a token
delivered in the window."""


def read(rec):
    if not rec["tokens"] or not rec["crypto_s"]:
        return None
    return rec["crypto_s"] * 1e3 / rec["tokens"]
