"""graftingress signed-transaction codec — Python twin of the pinned C++
frame header (native/src/mempool/tx_frame.hpp): the port's copy of
hotstuff_tpu/crypto/txsign.py, unchanged but for this line (the port
imports nothing of the JAX package).  It signs and verifies through the
port's pure-Python ``ref_ed25519``; ``INGRESS_CTX`` lives here and the
sidecar imports it.

Frame layout (version 2, all integers big-endian)::

    [0]        version      = TX_FRAME_VERSION (2)
    [1:33]     user pubkey  (Ed25519; derived from seed + user index)
    [33:41]    nonce        (u64; client-local monotonic counter)
    [41:45]    payload_len  (u32; must equal len(frame) - TX_FRAME_OVERHEAD)
    [45:45+n]  payload      (legacy inner tx: marker u8 + id u64 BE +
                             padding; marker 0=sample, 1=filler,
                             2=forged-marker)
    [-64:]     signature    (Ed25519 over the signing preimage)

Signing preimage: ``SHA-512(TX_SIGN_DOMAIN + frame[:-64])[:32]`` — the
32-byte digest is the Ed25519 message, the same (digest, pk, sig) record
shape every verify path in this repo ships to the sidecar bulk lane.

Per-user keys are derived deterministically so a verifier can recompute
any user's pubkey without key distribution::

    seed32 = SHA-512(TX_KEY_DOMAIN + seed u64 BE + user u64 BE)[:32]

graftlint's wire cross-checker (analysis/wirecheck.py, rule
``txframe-mismatch``) asserts the constants below match the C++ header —
edit BOTH sides or the gate fails.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import NamedTuple

from . import ref_ed25519

TX_FRAME_VERSION = 2
TX_PK_LEN = 32
TX_NONCE_LEN = 8
TX_LEN_LEN = 4
TX_SIG_LEN = 64
TX_FRAME_HEADER_LEN = 45   # version + pubkey + nonce + payload_len
TX_FRAME_OVERHEAD = 109    # header + signature
TX_MIN_PAYLOAD = 9         # marker + u64 id
TX_MAX_PAYLOAD = 1048576   # 1 MiB
TX_MARKER_SAMPLE = 0
TX_MARKER_FILLER = 1
TX_MARKER_FORGED = 2

TX_SIGN_DOMAIN = b"graftingress-tx-v1"
TX_KEY_DOMAIN = b"graftingress-key-v1"
# Sidecar context tag for admission-verify batches: exactly CTX_LEN(32)
# bytes and deliberately NON-zero (protocol.py decodes an all-zero ctx
# as "no tag", which would hide ingress-fed bulk records from OP_STATS).
INGRESS_CTX = b"graftingress-tx-admission-ctx-v1"
assert len(INGRESS_CTX) == 32 and any(INGRESS_CTX)

assert TX_FRAME_HEADER_LEN == 1 + TX_PK_LEN + TX_NONCE_LEN + TX_LEN_LEN
assert TX_FRAME_OVERHEAD == TX_FRAME_HEADER_LEN + TX_SIG_LEN


class TxFrameError(ValueError):
    """Structurally invalid signed-tx frame; .reason mirrors the C++
    TxParse enum (``not-signed`` / ``truncated`` / ``bad-payload-len``)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


class SignedTx(NamedTuple):
    pk: bytes
    nonce: int
    payload: bytes
    sig: bytes


def derive_user_seed(seed: int, user: int) -> bytes:
    """32-byte Ed25519 key seed for (bench seed, user index)."""
    pre = (TX_KEY_DOMAIN + int(seed).to_bytes(8, "big")
           + int(user).to_bytes(8, "big"))
    return hashlib.sha512(pre).digest()[:32]


def derive_user_keypair(seed: int, user: int) -> tuple[bytes, bytes]:
    """(signing seed, public key) for one simulated user."""
    return ref_ed25519.generate_keypair(derive_user_seed(seed, user))


class UserKeyring:
    """Bounded LRU of expanded per-user keypairs (derive on first
    arrival): a 1e6-user sweep only ever holds ``capacity`` expanded
    keys, mirroring the C++ TxKeyring."""

    def __init__(self, seed: int, capacity: int = 4096):
        self.seed = seed
        self.capacity = max(1, int(capacity))
        self.derivations = 0
        self._lru: OrderedDict[int, tuple[bytes, bytes]] = OrderedDict()

    def get(self, user: int) -> tuple[bytes, bytes]:
        kp = self._lru.get(user)
        if kp is not None:
            self._lru.move_to_end(user)
            return kp
        if len(self._lru) >= self.capacity:
            self._lru.popitem(last=False)
        kp = derive_user_keypair(self.seed, user)
        self._lru[user] = kp
        self.derivations += 1
        return kp

    def __len__(self) -> int:
        return len(self._lru)


def build_payload(marker: int, tx_id: int, size: int = TX_MIN_PAYLOAD) -> bytes:
    """Legacy inner tx payload: marker + u64 id + zero padding."""
    size = max(int(size), TX_MIN_PAYLOAD)
    body = bytes([marker]) + int(tx_id).to_bytes(8, "big")
    return body + b"\x00" * (size - len(body))


def preimage_digest(frame_without_sig: bytes) -> bytes:
    """32-byte Ed25519 message for a frame's signing preimage."""
    return hashlib.sha512(TX_SIGN_DOMAIN + frame_without_sig).digest()[:32]


def build_signed_tx(keypair: tuple[bytes, bytes], nonce: int, payload: bytes,
                    flip_sig_bit: bool = False) -> bytes:
    """One signed frame; ``flip_sig_bit`` forges the signature while
    keeping the structure valid (the seeded forgery mix)."""
    seed, pk = keypair
    head = (bytes([TX_FRAME_VERSION]) + pk
            + int(nonce).to_bytes(8, "big")
            + len(payload).to_bytes(4, "big") + payload)
    sig = ref_ed25519.sign(seed, preimage_digest(head))
    if flip_sig_bit:
        sig = bytes([sig[0] ^ 0x01]) + sig[1:]
    return head + sig


def parse_signed_tx(frame: bytes) -> SignedTx:
    """Structural parse; raises TxFrameError on malformed frames (the
    decode-level fuzz contract: error out, never mis-slice)."""
    if not frame or frame[0] != TX_FRAME_VERSION:
        raise TxFrameError("not-signed", f"first byte {frame[:1]!r}")
    if len(frame) < TX_FRAME_OVERHEAD + TX_MIN_PAYLOAD:
        raise TxFrameError("truncated", f"{len(frame)} B")
    plen = int.from_bytes(frame[41:45], "big")
    if plen < TX_MIN_PAYLOAD or plen > TX_MAX_PAYLOAD:
        raise TxFrameError("bad-payload-len", f"declared {plen}")
    if plen + TX_FRAME_OVERHEAD != len(frame):
        raise TxFrameError(
            "bad-payload-len",
            f"declared {plen} vs frame {len(frame)} B")
    return SignedTx(
        pk=frame[1:33],
        nonce=int.from_bytes(frame[33:41], "big"),
        payload=frame[45:45 + plen],
        sig=frame[45 + plen:],
    )


def admission_record(frame: bytes) -> tuple[bytes, bytes, bytes]:
    """(digest, pk, sig) verify record for one structurally valid frame
    — the exact triple the admission stage ships to OP_VERIFY_BULK."""
    tx = parse_signed_tx(frame)
    return preimage_digest(frame[:-TX_SIG_LEN]), tx.pk, tx.sig


def verify_tx(frame: bytes) -> bool:
    """Host ground-truth verify of one frame (test fixtures; slow)."""
    try:
        digest, pk, sig = admission_record(frame)
    except TxFrameError:
        return False
    return ref_ed25519.verify(pk, digest, sig)
