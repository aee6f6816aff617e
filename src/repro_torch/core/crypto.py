"""AES-256-GCM from the FIPS-197 / NIST SP 800-38D specs.

No crypto library ships in this container, and the paper's end-to-end
payload confidentiality claim ("the relay operator cannot read token
payloads", §5) is load-bearing for contribution C2 — so we implement
the real construction rather than stubbing it: AES-256 (14 rounds) in
CTR mode with a 96-bit nonce, GHASH over GF(2^128), 16-byte tag.
Validated against the NIST/GCM reference vectors in
tests/test_crypto.py. Token payloads are tiny, so pure-Python speed is
a non-issue on the data plane.

API mirrors cryptography.hazmat's AESGCM:
    AESGCM(key).encrypt(nonce, plaintext, aad) -> ciphertext||tag
    AESGCM(key).decrypt(nonce, ct_and_tag, aad) -> plaintext (raises on tamper)
plus JSON envelope helpers used by the relay data plane.
"""

from __future__ import annotations

import base64
import json
import os
import struct

# ---------------------------------------------------------------------------
# AES core (encrypt direction only; CTR/GCM never decrypts blocks)
# ---------------------------------------------------------------------------

_SBOX = [
    0x63, 0x7C, 0x77, 0x7B, 0xF2, 0x6B, 0x6F, 0xC5, 0x30, 0x01, 0x67, 0x2B, 0xFE, 0xD7, 0xAB, 0x76,
    0xCA, 0x82, 0xC9, 0x7D, 0xFA, 0x59, 0x47, 0xF0, 0xAD, 0xD4, 0xA2, 0xAF, 0x9C, 0xA4, 0x72, 0xC0,
    0xB7, 0xFD, 0x93, 0x26, 0x36, 0x3F, 0xF7, 0xCC, 0x34, 0xA5, 0xE5, 0xF1, 0x71, 0xD8, 0x31, 0x15,
    0x04, 0xC7, 0x23, 0xC3, 0x18, 0x96, 0x05, 0x9A, 0x07, 0x12, 0x80, 0xE2, 0xEB, 0x27, 0xB2, 0x75,
    0x09, 0x83, 0x2C, 0x1A, 0x1B, 0x6E, 0x5A, 0xA0, 0x52, 0x3B, 0xD6, 0xB3, 0x29, 0xE3, 0x2F, 0x84,
    0x53, 0xD1, 0x00, 0xED, 0x20, 0xFC, 0xB1, 0x5B, 0x6A, 0xCB, 0xBE, 0x39, 0x4A, 0x4C, 0x58, 0xCF,
    0xD0, 0xEF, 0xAA, 0xFB, 0x43, 0x4D, 0x33, 0x85, 0x45, 0xF9, 0x02, 0x7F, 0x50, 0x3C, 0x9F, 0xA8,
    0x51, 0xA3, 0x40, 0x8F, 0x92, 0x9D, 0x38, 0xF5, 0xBC, 0xB6, 0xDA, 0x21, 0x10, 0xFF, 0xF3, 0xD2,
    0xCD, 0x0C, 0x13, 0xEC, 0x5F, 0x97, 0x44, 0x17, 0xC4, 0xA7, 0x7E, 0x3D, 0x64, 0x5D, 0x19, 0x73,
    0x60, 0x81, 0x4F, 0xDC, 0x22, 0x2A, 0x90, 0x88, 0x46, 0xEE, 0xB8, 0x14, 0xDE, 0x5E, 0x0B, 0xDB,
    0xE0, 0x32, 0x3A, 0x0A, 0x49, 0x06, 0x24, 0x5C, 0xC2, 0xD3, 0xAC, 0x62, 0x91, 0x95, 0xE4, 0x79,
    0xE7, 0xC8, 0x37, 0x6D, 0x8D, 0xD5, 0x4E, 0xA9, 0x6C, 0x56, 0xF4, 0xEA, 0x65, 0x7A, 0xAE, 0x08,
    0xBA, 0x78, 0x25, 0x2E, 0x1C, 0xA6, 0xB4, 0xC6, 0xE8, 0xDD, 0x74, 0x1F, 0x4B, 0xBD, 0x8B, 0x8A,
    0x70, 0x3E, 0xB5, 0x66, 0x48, 0x03, 0xF6, 0x0E, 0x61, 0x35, 0x57, 0xB9, 0x86, 0xC1, 0x1D, 0x9E,
    0xE1, 0xF8, 0x98, 0x11, 0x69, 0xD9, 0x8E, 0x94, 0x9B, 0x1E, 0x87, 0xE9, 0xCE, 0x55, 0x28, 0xDF,
    0x8C, 0xA1, 0x89, 0x0D, 0xBF, 0xE6, 0x42, 0x68, 0x41, 0x99, 0x2D, 0x0F, 0xB0, 0x54, 0xBB, 0x16,
]

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36, 0x6C, 0xD8]


def _xtime(a: int) -> int:
    a <<= 1
    if a & 0x100:
        a ^= 0x11B
    return a & 0xFF


# precompute mul-by-2 and mul-by-3 tables for MixColumns
_MUL2 = [_xtime(i) for i in range(256)]
_MUL3 = [_xtime(i) ^ i for i in range(256)]


def _expand_key_256(key: bytes):
    assert len(key) == 32
    w = [list(key[4 * i : 4 * i + 4]) for i in range(8)]
    for i in range(8, 60):
        t = list(w[i - 1])
        if i % 8 == 0:
            t = t[1:] + t[:1]
            t = [_SBOX[b] for b in t]
            t[0] ^= _RCON[i // 8 - 1]
        elif i % 8 == 4:
            t = [_SBOX[b] for b in t]
        w.append([w[i - 8][j] ^ t[j] for j in range(4)])
    # 15 round keys of 16 bytes
    return [bytes(sum((w[4 * r + c] for c in range(4)), [])) for r in range(15)]


def _encrypt_block(block: bytes, round_keys) -> bytes:
    s = [block[i] ^ round_keys[0][i] for i in range(16)]
    for rnd in range(1, 14):
        # SubBytes + ShiftRows
        s = [_SBOX[s[(i + 4 * (i % 4)) % 16]] for i in range(16)]
        # MixColumns
        ns = [0] * 16
        for c in range(4):
            a0, a1, a2, a3 = s[4 * c : 4 * c + 4]
            ns[4 * c + 0] = _MUL2[a0] ^ _MUL3[a1] ^ a2 ^ a3
            ns[4 * c + 1] = a0 ^ _MUL2[a1] ^ _MUL3[a2] ^ a3
            ns[4 * c + 2] = a0 ^ a1 ^ _MUL2[a2] ^ _MUL3[a3]
            ns[4 * c + 3] = _MUL3[a0] ^ a1 ^ a2 ^ _MUL2[a3]
        rk = round_keys[rnd]
        s = [ns[i] ^ rk[i] for i in range(16)]
    # final round: no MixColumns
    s = [_SBOX[s[(i + 4 * (i % 4)) % 16]] for i in range(16)]
    rk = round_keys[14]
    return bytes(s[i] ^ rk[i] for i in range(16))


# ---------------------------------------------------------------------------
# GHASH / GCM
# ---------------------------------------------------------------------------

_R = 0xE1000000000000000000000000000000


def _gf_mult(x: int, y: int) -> int:
    """Carry-less multiply in GF(2^128) with the GCM polynomial."""
    z = 0
    v = x
    for i in range(127, -1, -1):
        if (y >> i) & 1:
            z ^= v
        if v & 1:
            v = (v >> 1) ^ _R
        else:
            v >>= 1
    return z


def _ghash(h: int, aad: bytes, ct: bytes) -> int:
    def blocks(data):
        for i in range(0, len(data), 16):
            b = data[i : i + 16]
            if len(b) < 16:
                b = b + b"\x00" * (16 - len(b))
            yield int.from_bytes(b, "big")

    y = 0
    for b in blocks(aad):
        y = _gf_mult(y ^ b, h)
    for b in blocks(ct):
        y = _gf_mult(y ^ b, h)
    lens = (len(aad) * 8) << 64 | (len(ct) * 8)
    return _gf_mult(y ^ lens, h)


class InvalidTag(Exception):
    """Authentication failure: payload was tampered with in transit."""


class AESGCM:
    TAG_LEN = 16
    NONCE_LEN = 12

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("AES-256-GCM requires a 32-byte key")
        self._rk = _expand_key_256(key)
        self._h = int.from_bytes(_encrypt_block(b"\x00" * 16, self._rk), "big")

    def _ctr(self, j0: bytes, data: bytes) -> bytes:
        out = bytearray()
        ctr = int.from_bytes(j0[12:], "big")
        prefix = j0[:12]
        for i in range(0, len(data), 16):
            ctr = (ctr + 1) & 0xFFFFFFFF
            ks = _encrypt_block(prefix + ctr.to_bytes(4, "big"), self._rk)
            chunk = data[i : i + 16]
            out.extend(bytes(a ^ b for a, b in zip(chunk, ks)))
        return bytes(out)

    def encrypt(self, nonce: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
        if len(nonce) != self.NONCE_LEN:
            raise ValueError("GCM nonce must be 12 bytes")
        j0 = nonce + b"\x00\x00\x00\x01"
        ct = self._ctr(j0, plaintext)
        s = _ghash(self._h, aad, ct)
        tag_ks = _encrypt_block(j0, self._rk)
        tag = bytes(a ^ b for a, b in zip(s.to_bytes(16, "big"), tag_ks))
        return ct + tag

    def decrypt(self, nonce: bytes, ct_and_tag: bytes, aad: bytes = b"") -> bytes:
        if len(ct_and_tag) < self.TAG_LEN:
            raise InvalidTag("truncated ciphertext")
        ct, tag = ct_and_tag[: -self.TAG_LEN], ct_and_tag[-self.TAG_LEN :]
        j0 = nonce + b"\x00\x00\x00\x01"
        s = _ghash(self._h, aad, ct)
        tag_ks = _encrypt_block(j0, self._rk)
        expect = bytes(a ^ b for a, b in zip(s.to_bytes(16, "big"), tag_ks))
        # constant-time-ish compare
        diff = 0
        for a, b in zip(expect, tag):
            diff |= a ^ b
        if diff or len(tag) != self.TAG_LEN:
            raise InvalidTag("GCM tag mismatch")
        return self._ctr(j0, ct)


# ---------------------------------------------------------------------------
# Envelope helpers (the relay sees only this opaque JSON)
# ---------------------------------------------------------------------------


def new_key() -> bytes:
    return os.urandom(32)


def encrypt_envelope(aes: AESGCM, payload: dict) -> dict:
    """Fresh 12-byte nonce per message (paper §5); base64 ciphertext."""
    nonce = os.urandom(12)
    pt = json.dumps(payload, separators=(",", ":")).encode()
    ct = aes.encrypt(nonce, pt)
    return {"enc": True,
            "nonce": base64.b64encode(nonce).decode(),
            "data": base64.b64encode(ct).decode()}


def decrypt_envelope(aes: AESGCM, env: dict) -> dict:
    if not env.get("enc"):
        return env
    nonce = base64.b64decode(env["nonce"])
    ct = base64.b64decode(env["data"])
    return json.loads(aes.decrypt(nonce, ct).decode())
