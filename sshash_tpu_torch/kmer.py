"""Host-side (NumPy) 2-bit DNA codec and packed-kmer algebra.

Bit conventions (identical to the reference, include/kmer.hpp:121-256):
  * encoding A=00, C=01, G=11, T=10  (char_to_uint(c) = (c >> 1) & 3,
    kmer.hpp:194); case-insensitive.
  * a kmer packs its FIRST character into the LOWEST bits: char j occupies
    bits [2j, 2j+2) (kmer.hpp:80: set(i, c) shifts by i*bits_per_char).
  * multi-word kmers are little-word-first: char j lives in 64-bit word
    j // 32 at bit offset 2*(j % 32).

The packed concatenated string set uses the same convention: the char at
global offset o lives in word o // 32 at bit offset 2*(o % 32) (this is the
append order of the reference's bits::bit_vector builder).
"""

import numpy as np

U64 = np.uint64
U32 = np.uint32

COMPLEMENT_XOR = 2  # code of complement(c) == c ^ 2 under the A=00,C=01,G=11,T=10 map

NUCLEOTIDES = "ACTG"  # code -> char: index c gives the char whose code is c
# code_to_char[0b00]='A', [0b01]='C', [0b10]='T', [0b11]='G'

_CHAR_TO_CODE = np.full(256, 255, dtype=np.uint8)
for _c in b"ACGTacgt":
    _CHAR_TO_CODE[_c] = (_c >> 1) & 3
_CODE_TO_CHAR = np.frombuffer(NUCLEOTIDES.encode(), dtype=np.uint8)

# reverse char map for building the RC of a char string
# (reference: kmer.hpp:233-243)
_CHAR_RC = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCAtgca"):
    _CHAR_RC[_a] = _b


def encode_chars(buf):
    """bytes/uint8 array -> (codes uint8 with 255 for invalid, valid bool)."""
    arr = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) else np.asarray(buf, dtype=np.uint8)
    codes = _CHAR_TO_CODE[arr]
    return codes, codes != 255


def decode_codes(codes):
    """uint8 codes -> ASCII bytes."""
    return _CODE_TO_CHAR[np.asarray(codes, dtype=np.uint8)].tobytes()


def revcomp_str(s):
    if isinstance(s, str):
        s = s.encode()
    arr = np.frombuffer(s, dtype=np.uint8)
    return _CHAR_RC[arr][::-1].tobytes().decode()


def num_words64(k):
    return (2 * k + 63) // 64


def pack_codes(codes, pad_words=0):
    """Pack 2-bit codes (uint8, invalid entries must be 0-3) into uint64 words,
    char j -> word j//32 bits 2*(j%32). Appends `pad_words` zero sentinel words
    (reference appends one kmer-width of zeros, encode_strings.cpp:183-188)."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    nw = (n + 31) // 32
    padded = np.zeros(nw * 32, dtype=np.uint8)
    padded[:n] = codes
    # pack 4 chars/byte first (cheap uint8 ops), then view as uint64
    b = padded.reshape(-1, 4)
    by = (b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4) | (b[:, 3] << 6)).astype(np.uint8)
    out = np.zeros(nw + pad_words, dtype=U64)
    out[:nw] = by.view("<u8")
    return out


def read_kmers_at(words, offsets, k):
    """Gather kmers of length k at char offsets from a packed words array.

    words: uint64[NW] with at least num_words64(k)+1 sentinel words of
    headroom past the last valid char.  offsets: int array (N,).
    Returns uint64[N, num_words64(k)], chars past k zeroed.

    Implementation note: this host gathers at BYTE granularity so the
    per-element residual shift has only 4 possible values {0,2,4,6}, each
    applied as a constant multiword shift + select (per-element variable
    64-bit shifts are pathologically slow in NumPy on this platform).
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    W = num_words64(k)
    bytes_view = words.view(np.uint8)  # little-endian: byte j = chars 4j..4j+3
    nb = 8 * W + 1  # enough bytes for 2k bits at any sub-byte phase
    bidx = (offsets >> 2)[:, None] + np.arange(nb)[None, :]
    g = np.take(bytes_view, bidx)  # (N, nb) uint8
    # assemble W+1 uint64 words from bytes (constant shifts)
    gw = np.zeros((len(offsets), W + 1), dtype=U64)
    for t in range(8):
        gw[:, :W] |= g[:, t : t + 8 * W : 8].astype(U64) << U64(8 * t)
    gw[:, W] = g[:, 8 * W]
    # residual shift: 2 * (offset % 4) in {0, 2, 4, 6}
    phase = (offsets & 3)[:, None]
    out = gw[:, :W]
    for s in (2, 4, 6):
        shifted = (gw[:, :W] >> U64(s)) | (gw[:, 1:] << U64(64 - s))
        out = np.where(phase == (s >> 1), shifted, out)
    rem = 2 * k - 64 * (W - 1)
    mask = U64(0xFFFFFFFFFFFFFFFF) if rem == 64 else U64((1 << rem) - 1)
    out[:, W - 1] = out[:, W - 1] & mask
    return out


def crc64(x):
    """Reverse-complement a full 32-char word (reference kmer.hpp:141-157):
    complement (xor 0b10 per char), byteswap, swap char order within bytes."""
    x = np.asarray(x, dtype=U64)
    c = x ^ U64(0xAAAAAAAAAAAAAAAA)
    # byteswap via shifts (equivalent to __builtin_bswap64)
    res = ((c & U64(0x00000000FFFFFFFF)) << U64(32)) | ((c & U64(0xFFFFFFFF00000000)) >> U64(32))
    res = ((res & U64(0x0000FFFF0000FFFF)) << U64(16)) | ((res & U64(0xFFFF0000FFFF0000)) >> U64(16))
    res = ((res & U64(0x00FF00FF00FF00FF)) << U64(8)) | ((res & U64(0xFF00FF00FF00FF00)) >> U64(8))
    c1 = U64(0x0F0F0F0F0F0F0F0F)
    c2 = U64(0x3333333333333333)
    res = ((res & c1) << U64(4)) | ((res & (c1 << U64(4))) >> U64(4))
    res = ((res & c2) << U64(2)) | ((res & (c2 << U64(2))) >> U64(2))
    return res


def revcomp_kmers(kmers, k):
    """Reverse-complement packed kmers, shape (N, W) uint64 (W = num_words64(k)).

    Same scheme as reference reverse_complement_inplace (kmer.hpp:159-165):
    crc64 each word, reverse word order, then right-shift by W*64 - 2k bits.
    """
    kmers = np.atleast_2d(np.asarray(kmers, dtype=U64))
    W = kmers.shape[-1]
    rev = crc64(kmers)[:, ::-1]
    s = W * 64 - 2 * k
    if s == 0:
        return rev
    # multiword right shift by s (< 64) bits
    out = rev >> U64(s)
    out[:, :-1] |= rev[:, 1:] << U64(64 - s)
    return out


def revcomp_mmers(vals, m):
    """RC of scalar m-mers (m <= 31) stored in uint64: crc64 then shift."""
    return crc64(vals) >> U64(64 - 2 * m)


def kmers_to_u32(kmers64, k):
    """(N, W64) uint64 -> (N, W32) uint32 little-word-first, W32=ceil(2k/32)."""
    kmers64 = np.atleast_2d(np.asarray(kmers64, dtype=U64))
    n, w = kmers64.shape
    lo = (kmers64 & U64(0xFFFFFFFF)).astype(U32)
    hi = (kmers64 >> U64(32)).astype(U32)
    out = np.empty((n, 2 * w), dtype=U32)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    w32 = (2 * k + 31) // 32
    return out[:, :w32]


def u32_to_kmers64(words32, k):
    words32 = np.atleast_2d(np.asarray(words32, dtype=U32))
    n, w32 = words32.shape
    w64 = num_words64(k)
    padded = np.zeros((n, 2 * w64), dtype=U64)
    padded[:, :w32] = words32
    return (padded[:, 0::2] | (padded[:, 1::2] << U64(32))).astype(U64)


def pack_words_to_u32(words64):
    """uint64[NW] packed strings -> uint32[2*NW] little-word-first."""
    words64 = np.asarray(words64, dtype=U64)
    out = np.empty(2 * len(words64), dtype=U32)
    out[0::2] = (words64 & U64(0xFFFFFFFF)).astype(U32)
    out[1::2] = (words64 >> U64(32)).astype(U32)
    return out


# --------------------------------------------------------------- amino acids
# 5-bit 26-letter protein alphabet (reference kmer.hpp:258-301,
# aa_uint_kmer_t). Reverse complement is the identity (proteins have no
# strands), so canonical mode degenerates to regular. Exposed as a codec
# (the reference defines the type but wires no tool to it).

AA_BITS = 5
_AA_TO_CODE = np.full(256, 255, dtype=np.uint8)
for _i in range(26):
    _AA_TO_CODE[ord("A") + _i] = _i
    _AA_TO_CODE[ord("a") + _i] = _i
_CODE_TO_AA = np.frombuffer(bytes(ord("A") + i for i in range(26)), dtype=np.uint8)


def aa_encode_chars(buf):
    """bytes -> (5-bit codes uint8 with 255 invalid, valid bool)."""
    arr = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) else np.asarray(buf, dtype=np.uint8)
    codes = _AA_TO_CODE[arr]
    return codes, codes != 255


def aa_decode_codes(codes):
    return _CODE_TO_AA[np.asarray(codes, dtype=np.uint8)].tobytes()


def aa_num_words64(k):
    return (AA_BITS * k + 63) // 64


def aa_pack(codes):
    """5-bit codes -> packed uint64 words, char j at bits [5j, 5j+5)
    (reference uint_kmer_t::set with bits_per_char=5, kmer.hpp:80)."""
    codes = np.asarray(codes, dtype=np.uint64)
    k = len(codes)
    out = np.zeros(aa_num_words64(k), dtype=U64)
    for j, c in enumerate(codes):
        w, b = divmod(AA_BITS * j, 64)
        out[w] |= (c << U64(b)) & U64(0xFFFFFFFFFFFFFFFF)
        if b > 64 - AA_BITS and w + 1 < len(out):
            out[w + 1] |= c >> U64(64 - b)
    return out


def aa_unpack(words, k):
    words = np.asarray(words, dtype=U64).reshape(-1)
    codes = np.empty(k, dtype=np.uint8)
    for j in range(k):
        w, b = divmod(AA_BITS * j, 64)
        v = words[w] >> U64(b)
        if b > 64 - AA_BITS and w + 1 < len(words):
            v |= words[w + 1] << U64(64 - b)
        codes[j] = int(v & U64((1 << AA_BITS) - 1))
    return codes


def string_to_kmer(s, k=None):
    """ASCII kmer -> packed uint64[W] (reference util.hpp:207-213)."""
    if k is None:
        k = len(s)
    codes, ok = encode_chars(s.encode() if isinstance(s, str) else s)
    assert ok.all() and len(codes) == k
    return pack_codes(codes)[: num_words64(k)]


def kmer_to_string(kmer, k):
    """packed uint64[W] -> ASCII kmer (reference util.hpp:215-219)."""
    kmer = np.asarray(kmer, dtype=U64).reshape(-1)
    chars = []
    for j in range(k):
        w, b = divmod(2 * j, 64)
        chars.append(int((kmer[w] >> U64(b)) & U64(3)))
    return decode_codes(chars).decode()
