// GROMACS XTC trajectory writer (XDR + xdr3dfcoord compressed coordinates).
//
// Replaces the reference's mdtraj.save_xtc dependency (reference
// `sim_inference.py:121-124`) with a dependency-free native writer. The
// compressed-coordinate scheme is the classic Frans van Hoesel algorithm
// from the public xdrfile library: quantize to ints at `precision`
// points/nm, encode the first atom of each run with a multi-radix big-int
// over the frame's bounding box, then delta-encode runs of nearby atoms
// with an adaptive "smallidx" bit width.
//
// Format per frame:
//   magic=1995, natoms, step, time          (XDR big-endian int/float)
//   box[3][3] floats (nm)
//   natoms again; if natoms <= 9: raw floats, else:
//   precision, minint[3], maxint[3], smallidx, nbytes, packed bytes (pad 4)
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int MAGIC = 1995;

const int magicints[] = {
    0,       0,       0,       0,       0,        0,        0,       0,
    0,       8,       10,      12,      16,       20,       25,      32,
    40,      50,      64,      80,      101,      128,      161,     203,
    256,     322,     406,     512,     645,      812,      1024,    1290,
    1625,    2048,    2580,    3250,    4096,     5160,     6501,    8192,
    10321,   13003,   16384,   20642,   26007,    32768,    41285,   52015,
    65536,   82570,   104031,  131072,  165140,   208063,   262144,  330280,
    416127,  524287,  660561,  832255,  1048576,  1321122,  1664510, 2097152,
    2642245, 3329021, 4194304, 5284491, 6658042,  8388607,  10568983,
    13316085, 16777216};
const int FIRSTIDX = 9;
const int LASTIDX = (int)(sizeof(magicints) / sizeof(int)) - 1;

struct Xdr {
  FILE* f;
  bool ok = true;
  void put_u32(uint32_t v) {
    unsigned char b[4] = {(unsigned char)(v >> 24), (unsigned char)(v >> 16),
                          (unsigned char)(v >> 8), (unsigned char)v};
    ok = ok && fwrite(b, 1, 4, f) == 4;
  }
  void put_int(int32_t v) { put_u32((uint32_t)v); }
  void put_float(float v) {
    uint32_t u;
    std::memcpy(&u, &v, 4);
    put_u32(u);
  }
  void put_opaque(const unsigned char* data, uint32_t n) {
    ok = ok && fwrite(data, 1, n, f) == n;
    static const unsigned char pad[4] = {0, 0, 0, 0};
    uint32_t rem = n % 4;
    if (rem) ok = ok && fwrite(pad, 1, 4 - rem, f) == 4 - rem;
  }
};

struct BitBuf {
  std::vector<unsigned char> bytes;
  uint32_t cnt = 0;
  int lastbits = 0;
  uint32_t lastbyte = 0;

  void sendbits(int num_of_bits, uint32_t num) {
    while (num_of_bits >= 8) {
      lastbyte = (lastbyte << 8) | ((num >> (num_of_bits - 8)) & 0xff);
      bytes[cnt++] = (unsigned char)(lastbyte >> lastbits);
      num_of_bits -= 8;
    }
    if (num_of_bits > 0) {
      lastbyte = (lastbyte << num_of_bits) | (num & ((1u << num_of_bits) - 1));
      lastbits += num_of_bits;
      if (lastbits >= 8) {
        lastbits -= 8;
        bytes[cnt++] = (unsigned char)(lastbyte >> lastbits);
      }
    }
    if (lastbits > 0) bytes[cnt] = (unsigned char)(lastbyte << (8 - lastbits));
  }

  void sendints(int num_of_ints, int num_of_bits, const uint32_t sizes[],
                const uint32_t nums[]) {
    uint32_t bytes_[32], tmp;
    int num_of_bytes = 0, bytecnt, i;
    tmp = nums[0];
    do {
      bytes_[num_of_bytes++] = tmp & 0xff;
      tmp >>= 8;
    } while (tmp != 0);
    for (i = 1; i < num_of_ints; i++) {
      tmp = nums[i];
      for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
        tmp = bytes_[bytecnt] * sizes[i] + tmp;
        bytes_[bytecnt] = tmp & 0xff;
        tmp >>= 8;
      }
      while (tmp != 0) {
        bytes_[bytecnt++] = tmp & 0xff;
        tmp >>= 8;
      }
      num_of_bytes = bytecnt;
    }
    if (num_of_bits >= num_of_bytes * 8) {
      for (i = 0; i < num_of_bytes; i++) sendbits(8, bytes_[i]);
      sendbits(num_of_bits - num_of_bytes * 8, 0);
    } else {
      for (i = 0; i < num_of_bytes - 1; i++) sendbits(8, bytes_[i]);
      sendbits(num_of_bits - (num_of_bytes - 1) * 8, bytes_[i]);
    }
  }
};

int sizeofint(int size) {
  int num = 1, num_of_bits = 0;
  while (size >= num && num_of_bits < 32) {
    num_of_bits++;
    num <<= 1;
  }
  return num_of_bits;
}

int sizeofints(int num_of_ints, const uint32_t sizes[]) {
  int i;
  uint32_t num_of_bytes = 1, num_of_bits = 0, bytes[32], bytecnt, tmp;
  uint32_t num;
  bytes[0] = 1;
  for (i = 0; i < num_of_ints; i++) {
    tmp = 0;
    for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
      tmp = bytes[bytecnt] * sizes[i] + tmp;
      bytes[bytecnt] = tmp & 0xff;
      tmp >>= 8;
    }
    while (tmp != 0) {
      bytes[bytecnt++] = tmp & 0xff;
      tmp >>= 8;
    }
    num_of_bytes = bytecnt;
  }
  num = 1;
  num_of_bytes--;
  while (bytes[num_of_bytes] >= num) {
    num_of_bits++;
    num *= 2;
  }
  return (int)(num_of_bits + num_of_bytes * 8);
}

inline int quantize(float lf) {
  return (int)(lf >= 0.0f ? lf + 0.5f : lf - 0.5f);
}

// Encode one frame's coordinates (nm) as xdr3dfcoord. Returns false on I/O
// or range error.
bool write_frame_coords(Xdr& x, const float* coords, int natoms,
                        float precision) {
  x.put_int(natoms);
  const int size3 = natoms * 3;
  if (natoms <= 9) {
    for (int i = 0; i < size3; i++) x.put_float(coords[i]);
    return x.ok;
  }
  x.put_float(precision);

  std::vector<int> ip(size3);
  int minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
  int maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
  int mindiff = INT32_MAX;
  int oldl[3] = {0, 0, 0};
  for (int i = 0; i < natoms; i++) {
    int l[3];
    for (int d = 0; d < 3; d++) {
      float lf = coords[i * 3 + d] * precision;
      if (lf >= (float)INT32_MAX / 2 || lf <= (float)INT32_MIN / 2)
        return false;  // out of quantizable range
      l[d] = quantize(lf);
      if (l[d] < minint[d]) minint[d] = l[d];
      if (l[d] > maxint[d]) maxint[d] = l[d];
      ip[i * 3 + d] = l[d];
    }
    int diff =
        abs(oldl[0] - l[0]) + abs(oldl[1] - l[1]) + abs(oldl[2] - l[2]);
    if (diff < mindiff && i > 0) mindiff = diff;
    oldl[0] = l[0];
    oldl[1] = l[1];
    oldl[2] = l[2];
  }
  for (int d = 0; d < 3; d++) x.put_int(minint[d]);
  for (int d = 0; d < 3; d++) x.put_int(maxint[d]);

  if ((double)maxint[0] - minint[0] >= (double)INT32_MAX / 2 ||
      (double)maxint[1] - minint[1] >= (double)INT32_MAX / 2 ||
      (double)maxint[2] - minint[2] >= (double)INT32_MAX / 2)
    return false;

  uint32_t sizeint[3] = {(uint32_t)(maxint[0] - minint[0] + 1),
                         (uint32_t)(maxint[1] - minint[1] + 1),
                         (uint32_t)(maxint[2] - minint[2] + 1)};
  int bitsizeint[3] = {0, 0, 0};
  int bitsize;
  if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
    bitsizeint[0] = sizeofint(sizeint[0]);
    bitsizeint[1] = sizeofint(sizeint[1]);
    bitsizeint[2] = sizeofint(sizeint[2]);
    bitsize = 0;
  } else {
    bitsize = sizeofints(3, sizeint);
  }

  int smallidx = FIRSTIDX;
  while (smallidx < LASTIDX && magicints[smallidx] < mindiff) smallidx++;
  x.put_int(smallidx);

  int maxidx = smallidx + 8 < LASTIDX ? smallidx + 8 : LASTIDX;
  int minidx = maxidx - 8;
  int smaller = magicints[smallidx > FIRSTIDX ? smallidx - 1 : FIRSTIDX] / 2;
  int smallnum = magicints[smallidx] / 2;
  uint32_t sizesmall[3] = {(uint32_t)magicints[smallidx],
                           (uint32_t)magicints[smallidx],
                           (uint32_t)magicints[smallidx]};
  int larger = magicints[maxidx] / 2;

  BitBuf buf;
  buf.bytes.assign((size_t)size3 * 4 + 32, 0);

  int prevcoord[3] = {0, 0, 0};
  int prevrun = -1;
  int i = 0;
  while (i < natoms) {
    bool is_small = false;
    int* thiscoord = ip.data() + (size_t)i * 3;
    int is_smaller;
    if (smallidx < maxidx && i >= 1 &&
        abs(thiscoord[0] - prevcoord[0]) < larger &&
        abs(thiscoord[1] - prevcoord[1]) < larger &&
        abs(thiscoord[2] - prevcoord[2]) < larger) {
      is_smaller = 1;
    } else if (smallidx > minidx) {
      is_smaller = -1;
    } else {
      is_smaller = 0;
    }
    if (i + 1 < natoms) {
      if (abs(thiscoord[0] - thiscoord[3]) < smallnum &&
          abs(thiscoord[1] - thiscoord[4]) < smallnum &&
          abs(thiscoord[2] - thiscoord[5]) < smallnum) {
        // interchange with the next atom so waters compress better
        for (int d = 0; d < 3; d++) {
          int t = thiscoord[d];
          thiscoord[d] = thiscoord[d + 3];
          thiscoord[d + 3] = t;
        }
        is_small = true;
      }
    }
    uint32_t tmpcoord[30];
    tmpcoord[0] = (uint32_t)(thiscoord[0] - minint[0]);
    tmpcoord[1] = (uint32_t)(thiscoord[1] - minint[1]);
    tmpcoord[2] = (uint32_t)(thiscoord[2] - minint[2]);
    if (bitsize == 0) {
      buf.sendbits(bitsizeint[0], tmpcoord[0]);
      buf.sendbits(bitsizeint[1], tmpcoord[1]);
      buf.sendbits(bitsizeint[2], tmpcoord[2]);
    } else {
      buf.sendints(3, bitsize, sizeint, tmpcoord);
    }
    prevcoord[0] = thiscoord[0];
    prevcoord[1] = thiscoord[1];
    prevcoord[2] = thiscoord[2];
    thiscoord = thiscoord + 3;
    i++;

    int run = 0;
    if (!is_small && is_smaller == -1) is_smaller = 0;
    while (is_small && run < 8 * 3) {
      long sd0 = thiscoord[0] - prevcoord[0];
      long sd1 = thiscoord[1] - prevcoord[1];
      long sd2 = thiscoord[2] - prevcoord[2];
      if (is_smaller == -1 &&
          sd0 * sd0 + sd1 * sd1 + sd2 * sd2 >= (long)smaller * smaller) {
        is_smaller = 0;
      }
      tmpcoord[run++] = (uint32_t)(sd0 + smallnum);
      tmpcoord[run++] = (uint32_t)(sd1 + smallnum);
      tmpcoord[run++] = (uint32_t)(sd2 + smallnum);

      prevcoord[0] = thiscoord[0];
      prevcoord[1] = thiscoord[1];
      prevcoord[2] = thiscoord[2];
      i++;
      thiscoord = thiscoord + 3;
      is_small = false;
      if (i < natoms && abs(thiscoord[0] - prevcoord[0]) < smallnum &&
          abs(thiscoord[1] - prevcoord[1]) < smallnum &&
          abs(thiscoord[2] - prevcoord[2]) < smallnum) {
        is_small = true;
      }
    }
    if (run != prevrun || is_smaller != 0) {
      prevrun = run;
      buf.sendbits(1, 1);  // run-length changed
      buf.sendbits(5, (uint32_t)(run + is_smaller + 1));
    } else {
      buf.sendbits(1, 0);
    }
    for (int k = 0; k < run; k += 3) {
      buf.sendints(3, smallidx, sizesmall, &tmpcoord[k]);
    }
    if (is_smaller != 0) {
      smallidx += is_smaller;
      if (is_smaller < 0) {
        smallnum = smaller;
        smaller = magicints[smallidx - 1] / 2;
      } else {
        smaller = smallnum;
        smallnum = magicints[smallidx] / 2;
      }
      sizesmall[0] = sizesmall[1] = sizesmall[2] =
          (uint32_t)magicints[smallidx];
    }
  }
  uint32_t nbytes = buf.cnt + (buf.lastbits != 0 ? 1 : 0);
  x.put_int((int)nbytes);
  x.put_opaque(buf.bytes.data(), nbytes);
  return x.ok;
}

}  // namespace

extern "C" {

// coords: [T, N, 3] float32 in NANOMETERS. steps/times may be null
// (defaults: step i, time = i as float). Returns 0 on success.
int64_t mdgen_write_xtc(const float* coords, int64_t T, int64_t N,
                        const int32_t* steps, const float* times,
                        float precision, const char* path) {
  if (T <= 0 || N <= 0 || coords == nullptr) return -1;
  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  Xdr x{f};
  for (int64_t t = 0; t < T; t++) {
    x.put_int(MAGIC);
    x.put_int((int)N);
    x.put_int(steps ? steps[t] : (int32_t)t);
    x.put_float(times ? times[t] : (float)t);
    for (int i = 0; i < 9; i++) x.put_float(0.0f);  // no unit cell
    if (!write_frame_coords(x, coords + (size_t)t * N * 3, (int)N,
                            precision) ||
        !x.ok) {
      fclose(f);
      return -3;
    }
  }
  fclose(f);
  return 0;
}
}
