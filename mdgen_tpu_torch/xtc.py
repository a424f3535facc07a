"""GROMACS XTC trajectory I/O + Kabsch superposition (host-side).

A copy of ``mdgen_tpu/xtc.py`` without its native C++ writer: the pure
NumPy/Python encoder, which writes the same bytes as the native one, and the
Python reader. Both implement the classic xdrfile ``xdr3dfcoord``
compressed-coordinate algorithm.

Coordinates are in NANOMETERS on disk (GROMACS convention); helpers below
take Angstroms (the framework's unit) and convert.
"""
from __future__ import annotations

import struct

import numpy as np

MAGIC = 1995

_MAGICINTS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290,
    1625, 2048, 2580, 3250, 4096, 5160, 6501, 8192, 10321, 13003, 16384,
    20642, 26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072,
    165140, 208063, 262144, 330280, 416127, 524287, 660561, 832255,
    1048576, 1321122, 1664510, 2097152, 2642245, 3329021, 4194304,
    5284491, 6658042, 8388607, 10568983, 13316085, 16777216,
]
_FIRSTIDX = 9
_LASTIDX = len(_MAGICINTS) - 1


# ---------------------------------------------------------------------------
# Kabsch superposition
# ---------------------------------------------------------------------------


def kabsch(mobile: np.ndarray, ref: np.ndarray, weights=None):
    """Optimal rotation R and translations such that
    (mobile - cm) @ R + cr approximates ref. Returns (R [3,3], cm, cr)."""
    w = (np.ones(len(mobile)) if weights is None else np.asarray(weights))
    w = (w / w.sum())[:, None]
    cm = (mobile * w).sum(0)
    cr = (ref * w).sum(0)
    H = (mobile - cm).T @ ((ref - cr) * w)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    return R, cm, cr


def superpose(coords: np.ndarray, mask=None) -> np.ndarray:
    """Align every frame to frame 0 (mdtraj ``traj.superpose(traj)``
    semantics: mass-unweighted Kabsch on all selected atoms).

    coords: [T, N, 3]; mask: optional [N] with 1 = use atom for the fit
    (all atoms still get transformed). Returns the aligned copy.
    """
    coords = np.asarray(coords, np.float64)
    T = coords.shape[0]
    sel = slice(None) if mask is None else np.asarray(mask) > 0.5
    ref = coords[0][sel]
    out = np.empty_like(coords)
    out[0] = coords[0]
    for t in range(1, T):
        R, cm, cr = kabsch(coords[t][sel], ref)
        out[t] = (coords[t] - cm) @ R + cr
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Bit packing (xdrfile sendbits/sendints)
# ---------------------------------------------------------------------------


def _sizeofint(size: int) -> int:
    num, bits = 1, 0
    while size >= num and bits < 32:
        bits += 1
        num <<= 1
    return bits


def _sizeofints(sizes) -> int:
    num_of_bytes = 1
    bytes_ = [1]
    for s in sizes:
        tmp = 0
        for i in range(num_of_bytes):
            tmp = bytes_[i] * s + tmp
            bytes_[i] = tmp & 0xFF
            tmp >>= 8
        while tmp != 0:
            bytes_.append(tmp & 0xFF)
            tmp >>= 8
        num_of_bytes = len(bytes_)
    num, bits = 1, 0
    top = bytes_[num_of_bytes - 1]
    while top >= num:
        bits += 1
        num *= 2
    return bits + (num_of_bytes - 1) * 8


class _BitWriter:
    def __init__(self, capacity: int):
        self.b = bytearray(capacity)
        self.cnt = 0
        self.lastbits = 0
        self.lastbyte = 0

    def sendbits(self, nbits: int, num: int):
        while nbits >= 8:
            self.lastbyte = ((self.lastbyte << 8) | ((num >> (nbits - 8)) & 0xFF)) & 0xFFFFFFFF
            self.b[self.cnt] = (self.lastbyte >> self.lastbits) & 0xFF
            self.cnt += 1
            nbits -= 8
        if nbits > 0:
            self.lastbyte = ((self.lastbyte << nbits) | (num & ((1 << nbits) - 1))) & 0xFFFFFFFF
            self.lastbits += nbits
            if self.lastbits >= 8:
                self.lastbits -= 8
                self.b[self.cnt] = (self.lastbyte >> self.lastbits) & 0xFF
                self.cnt += 1
        if self.lastbits > 0:
            self.b[self.cnt] = (self.lastbyte << (8 - self.lastbits)) & 0xFF

    def sendints(self, nbits: int, sizes, nums):
        bytes_ = []
        tmp = nums[0]
        while True:
            bytes_.append(tmp & 0xFF)
            tmp >>= 8
            if tmp == 0:
                break
        for i in range(1, len(nums)):
            tmp = nums[i]
            for j in range(len(bytes_)):
                tmp = bytes_[j] * sizes[i] + tmp
                bytes_[j] = tmp & 0xFF
                tmp >>= 8
            while tmp != 0:
                bytes_.append(tmp & 0xFF)
                tmp >>= 8
        n = len(bytes_)
        if nbits >= n * 8:
            for v in bytes_:
                self.sendbits(8, v)
            self.sendbits(nbits - n * 8, 0)
        else:
            for v in bytes_[:-1]:
                self.sendbits(8, v)
            self.sendbits(nbits - (n - 1) * 8, bytes_[-1])

    def close(self) -> bytes:
        n = self.cnt + (1 if self.lastbits else 0)
        return bytes(self.b[:n])


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.cnt = 0
        self.lastbits = 0
        self.lastbyte = 0

    def receivebits(self, nbits: int) -> int:
        mask = (1 << nbits) - 1
        lastbits, lastbyte = self.lastbits, self.lastbyte
        num = 0
        while nbits >= 8:
            lastbyte = ((lastbyte << 8) | self.data[self.cnt]) & 0xFFFFFFFF
            self.cnt += 1
            num |= (lastbyte >> lastbits) << (nbits - 8)
            nbits -= 8
        if nbits > 0:
            if lastbits < nbits:
                lastbits += 8
                lastbyte = ((lastbyte << 8) | self.data[self.cnt]) & 0xFFFFFFFF
                self.cnt += 1
            lastbits -= nbits
            num |= (lastbyte >> lastbits) & ((1 << nbits) - 1)
        num &= mask
        self.lastbits, self.lastbyte = lastbits, lastbyte
        return num

    def receiveints(self, nints: int, nbits: int, sizes) -> list:
        bytes_ = [0] * 32
        num_of_bytes = 0
        while nbits > 8:
            bytes_[num_of_bytes] = self.receivebits(8)
            num_of_bytes += 1
            nbits -= 8
        if nbits > 0:
            bytes_[num_of_bytes] = self.receivebits(nbits)
            num_of_bytes += 1
        nums = [0] * nints
        for i in range(nints - 1, 0, -1):
            num = 0
            for j in range(num_of_bytes - 1, -1, -1):
                num = (num << 8) | bytes_[j]
                bytes_[j] = num // sizes[i]
                num -= bytes_[j] * sizes[i]
            nums[i] = num
        nums[0] = (
            bytes_[0] | (bytes_[1] << 8) | (bytes_[2] << 16) | (bytes_[3] << 24)
        )
        return nums


# ---------------------------------------------------------------------------
# Frame encode / decode (xdr3dfcoord)
# ---------------------------------------------------------------------------


def _encode_frame(coords_nm: np.ndarray, precision: float) -> bytes:
    """One frame's coordinate payload (everything after the 9 box floats)."""
    natoms = coords_nm.shape[0]
    out = bytearray()
    out += struct.pack(">i", natoms)
    if natoms <= 9:
        out += struct.pack(f">{natoms * 3}f", *coords_nm.reshape(-1))
        return bytes(out)
    out += struct.pack(">f", precision)

    lf = coords_nm.astype(np.float64) * precision
    ints = np.where(lf >= 0, lf + 0.5, lf - 0.5).astype(np.int64).astype(int)
    ip = ints.reshape(-1, 3)
    minint = ip.min(0)
    maxint = ip.max(0)
    diffs = np.abs(np.diff(ip, axis=0)).sum(1)
    mindiff = int(diffs.min()) if len(diffs) else 2**31 - 1
    out += struct.pack(">3i", *minint)
    out += struct.pack(">3i", *maxint)

    sizeint = [int(maxint[d] - minint[d] + 1) for d in range(3)]
    if (sizeint[0] | sizeint[1] | sizeint[2]) > 0xFFFFFF:
        bitsizeint = [_sizeofint(s) for s in sizeint]
        bitsize = 0
    else:
        bitsize = _sizeofints(sizeint)

    smallidx = _FIRSTIDX
    while smallidx < _LASTIDX and _MAGICINTS[smallidx] < mindiff:
        smallidx += 1
    out += struct.pack(">i", smallidx)

    maxidx = min(_LASTIDX, smallidx + 8)
    minidx = maxidx - 8
    smaller = _MAGICINTS[max(_FIRSTIDX, smallidx - 1)] // 2
    smallnum = _MAGICINTS[smallidx] // 2
    sizesmall = [_MAGICINTS[smallidx]] * 3
    larger = _MAGICINTS[maxidx] // 2

    w = _BitWriter(natoms * 12 + 32)
    ip = [list(row) for row in ip]
    prevcoord = [0, 0, 0]
    prevrun = -1
    i = 0
    while i < natoms:
        is_small = False
        this = ip[i]
        if (
            smallidx < maxidx
            and i >= 1
            and abs(this[0] - prevcoord[0]) < larger
            and abs(this[1] - prevcoord[1]) < larger
            and abs(this[2] - prevcoord[2]) < larger
        ):
            is_smaller = 1
        elif smallidx > minidx:
            is_smaller = -1
        else:
            is_smaller = 0
        if i + 1 < natoms:
            nxt = ip[i + 1]
            if (
                abs(this[0] - nxt[0]) < smallnum
                and abs(this[1] - nxt[1]) < smallnum
                and abs(this[2] - nxt[2]) < smallnum
            ):
                ip[i], ip[i + 1] = nxt, this
                this = ip[i]
                is_small = True
        tmp = [this[d] - int(minint[d]) for d in range(3)]
        if bitsize == 0:
            for d in range(3):
                w.sendbits(bitsizeint[d], tmp[d])
        else:
            w.sendints(bitsize, sizeint, tmp)
        prevcoord = list(this)
        i += 1

        run = 0
        runvals = []
        if not is_small and is_smaller == -1:
            is_smaller = 0
        while is_small and run < 8 * 3:
            this = ip[i]
            d0 = this[0] - prevcoord[0]
            d1 = this[1] - prevcoord[1]
            d2 = this[2] - prevcoord[2]
            if is_smaller == -1 and d0 * d0 + d1 * d1 + d2 * d2 >= smaller * smaller:
                is_smaller = 0
            runvals += [d0 + smallnum, d1 + smallnum, d2 + smallnum]
            run += 3
            prevcoord = list(this)
            i += 1
            is_small = False
            if (
                i < natoms
                and abs(ip[i][0] - prevcoord[0]) < smallnum
                and abs(ip[i][1] - prevcoord[1]) < smallnum
                and abs(ip[i][2] - prevcoord[2]) < smallnum
            ):
                is_small = True
        if run != prevrun or is_smaller != 0:
            prevrun = run
            w.sendbits(1, 1)
            w.sendbits(5, run + is_smaller + 1)
        else:
            w.sendbits(1, 0)
        for k in range(0, run, 3):
            w.sendints(smallidx, sizesmall, runvals[k : k + 3])
        if is_smaller != 0:
            smallidx += is_smaller
            if is_smaller < 0:
                smallnum = smaller
                smaller = _MAGICINTS[smallidx - 1] // 2
            else:
                smaller = smallnum
                smallnum = _MAGICINTS[smallidx] // 2
            sizesmall = [_MAGICINTS[smallidx]] * 3

    payload = w.close()
    out += struct.pack(">i", len(payload))
    out += payload
    out += b"\x00" * ((4 - len(payload) % 4) % 4)
    return bytes(out)


def _decode_frame(buf: memoryview, offset: int):
    """Decode one frame's coordinate payload; returns (coords_nm, offset)."""
    (natoms,) = struct.unpack_from(">i", buf, offset)
    offset += 4
    if natoms <= 9:
        coords = np.array(
            struct.unpack_from(f">{natoms * 3}f", buf, offset), np.float32
        ).reshape(natoms, 3)
        return coords, offset + natoms * 12
    (precision,) = struct.unpack_from(">f", buf, offset)
    offset += 4
    minint = struct.unpack_from(">3i", buf, offset)
    maxint = struct.unpack_from(">3i", buf, offset + 12)
    offset += 24
    sizeint = [maxint[d] - minint[d] + 1 for d in range(3)]
    if (sizeint[0] | sizeint[1] | sizeint[2]) > 0xFFFFFF:
        bitsizeint = [_sizeofint(s) for s in sizeint]
        bitsize = 0
    else:
        bitsize = _sizeofints(sizeint)
    (smallidx,) = struct.unpack_from(">i", buf, offset)
    offset += 4
    smaller = _MAGICINTS[max(_FIRSTIDX, smallidx - 1)] // 2
    smallnum = _MAGICINTS[smallidx] // 2
    sizesmall = [_MAGICINTS[smallidx]] * 3
    (nbytes,) = struct.unpack_from(">i", buf, offset)
    offset += 4
    r = _BitReader(bytes(buf[offset : offset + nbytes]))
    offset += nbytes + ((4 - nbytes % 4) % 4)

    # mirrors xdrfile_decompress_coord_float: the "water swap" on encode
    # puts the delta-coded atom FIRST in output order; after a run's first
    # delta, prevcoord stays on that delta atom (not the big-coded one)
    out = []
    prevcoord = [0, 0, 0]
    run = 0
    i = 0
    while i < natoms:
        if bitsize == 0:
            this = [r.receivebits(b) for b in bitsizeint]
        else:
            this = r.receiveints(3, bitsize, sizeint)
        this = [this[d] + minint[d] for d in range(3)]
        i += 1
        prevcoord = list(this)
        flag = r.receivebits(1)
        is_smaller = 0
        if flag == 1:
            run = r.receivebits(5)
            is_smaller = run % 3
            run -= is_smaller
            is_smaller -= 1
        if run > 0:
            for k in range(0, run, 3):
                dec = r.receiveints(3, smallidx, sizesmall)
                dec = [dec[d] + prevcoord[d] - smallnum for d in range(3)]
                i += 1
                if k == 0:
                    out.append(dec)  # swapped: delta atom first
                    out.append(this)  # big-coded atom second
                else:
                    out.append(dec)
                prevcoord = dec
        else:
            out.append(this)
        smallidx += is_smaller
        if is_smaller < 0:
            smallnum = smaller
            smaller = _MAGICINTS[smallidx - 1] // 2 if smallidx > _FIRSTIDX else 0
        elif is_smaller > 0:
            smaller = smallnum
            smallnum = _MAGICINTS[smallidx] // 2
        sizesmall = [_MAGICINTS[smallidx]] * 3

    coords = np.asarray(out, np.float64)
    return (coords / precision).astype(np.float32), offset


# ---------------------------------------------------------------------------
# File-level API
# ---------------------------------------------------------------------------


def write_xtc(
    path: str,
    coords_nm: np.ndarray,
    steps=None,
    times=None,
    precision: float = 1000.0,
) -> None:
    """Write [T, N, 3] nm coordinates as an XTC file (no unit cell)."""
    coords_nm = np.ascontiguousarray(coords_nm, np.float32)
    T, N = coords_nm.shape[:2]
    with open(path, "wb") as fh:
        for t in range(T):
            step = int(steps[t]) if steps is not None else t
            tim = float(times[t]) if times is not None else float(t)
            fh.write(struct.pack(">iiif", MAGIC, N, step, tim))
            fh.write(struct.pack(">9f", *([0.0] * 9)))
            fh.write(_encode_frame(coords_nm[t], precision))


def read_xtc(path: str):
    """Read an XTC file -> (coords_nm [T, N, 3], steps [T], times [T])."""
    with open(path, "rb") as fh:
        buf = memoryview(fh.read())
    frames, steps, times = [], [], []
    offset = 0
    while offset < len(buf):
        magic, natoms, step, tim = struct.unpack_from(">iiif", buf, offset)
        if magic != MAGIC:
            raise ValueError(f"bad XTC magic {magic} at offset {offset}")
        offset += 16 + 36  # header + box
        coords, offset = _decode_frame(buf, offset)
        assert coords.shape[0] == natoms
        frames.append(coords)
        steps.append(step)
        times.append(tim)
    return np.stack(frames), np.asarray(steps), np.asarray(times)


def write_xtc_angstrom(path: str, coords_ang: np.ndarray, **kw) -> None:
    """Framework-unit helper: Angstrom coordinates -> nm XTC."""
    write_xtc(path, np.asarray(coords_ang, np.float32) * 0.1, **kw)
