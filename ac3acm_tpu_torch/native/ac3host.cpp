// TPU-native AC-3 framework: native host pre-pass.
//
// The serial, bit-granular half of the decoder (syncinfo, BSI/side-info
// parse, spec-form bit allocation, mantissa-code extraction, dither LFSR)
// implemented as a C ABI shared library.  Python drives it via ctypes and
// feeds the dense (q, a, b) block tensors it emits straight to the TPU
// pipeline.  One parser instance per stream; instances are independent, so
// the host fans streams out across threads (the GIL is released during
// calls).
//
// Behavioural parity: liba52 parse.c / bit_allocate.c / downmix.c decode
// semantics, cross-checked bit-for-bit against the compiled reference in
// tests.  Derivation note: bit-exact float output pins the *evaluation
// order* of the filterbank and mixers to the reference's; that order is
// captured as data (butterfly schedules, synthesis index tables, mixer
// byte-code -- see ac3fb.inc) and executed by generic interpreters, the
// same planner/replay approach as the device-side ops/imdct_exact.py.
// The parser and allocator are spec-form (ATSC A/52) implementations.
//
// Build: g++ -O3 -march=native -fPIC -shared ac3host.cpp -o libac3host.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <mutex>

// ---------------------------------------------------------------------------
// constants & tables (generated at init, mirroring ac3acm_tpu/tables.py)
// ---------------------------------------------------------------------------

#define A52_CHANNEL 0
#define A52_MONO 1
#define A52_STEREO 2
#define A52_3F 3
#define A52_2F1R 4
#define A52_3F1R 5
#define A52_2F2R 6
#define A52_3F2R 7
#define A52_CHANNEL1 8
#define A52_CHANNEL2 9
#define A52_DOLBY 10
#define A52_CHANNEL_MASK 15
#define A52_LFE 16
#define A52_ADJUST_LEVEL 32

#define EXP_REUSE 0
#define DELTA_BIT_NEW 1
#define DELTA_BIT_NONE 2

static const int NFCHANS_TBL[11] = {2, 1, 2, 3, 3, 4, 4, 5, 1, 1, 2};
static const int REMATRIX_BAND[4] = {25, 37, 61, 253};
static const int RATE_TBL[19] = {32, 40, 48, 56, 64, 80, 96, 112, 128, 160,
                                 192, 224, 256, 320, 384, 448, 512, 576, 640};
static const int HALFRATE_TBL[12] = {0,0,0,0,0,0,0,0,0,1,2,3};

// spec tables, installed from Python at init time (single source of truth)
static int32_t g_latab[260];
static int32_t g_hth[50][3];
static int8_t  g_baptab[64];
static int32_t g_bndtab[51];
static int32_t g_bndsz[50];
static int32_t g_masktab[256];
static float   g_scale[25];
static float   g_q10[32], g_q11[32], g_q12[32];
static float   g_q20[128], g_q21[128], g_q22[128];
static float   g_q3[8], g_q40[128], g_q41[128], g_q5[16];
static uint16_t g_ditherlut[256];
static int32_t g_sdecay[4], g_fdecay[4], g_sgain[4], g_dbknee[4];
static int32_t g_floor[8], g_fgain[8];
static int8_t  g_exp1[128], g_exp2[128], g_exp3[128];
static int32_t g_cplbnd[16];
static int32_t g_bapbits[16];

extern "C" void ac3h_init(
    const int32_t* latab, const int32_t* hth, const int8_t* baptab,
    const int32_t* bndtab, const int32_t* bndsz, const int32_t* masktab,
    const float* scale, const float* q10, const float* q11, const float* q12,
    const float* q20, const float* q21, const float* q22, const float* q3,
    const float* q40, const float* q41, const float* q5,
    const uint16_t* ditherlut, const int32_t* sdecay, const int32_t* fdecay,
    const int32_t* sgain, const int32_t* dbknee, const int32_t* floortab,
    const int32_t* fgain, const int8_t* exp1, const int8_t* exp2,
    const int8_t* exp3, const int32_t* cplbnd, const int32_t* bapbits)
{
    memcpy(g_latab, latab, sizeof(g_latab));
    memcpy(g_hth, hth, sizeof(g_hth));
    memcpy(g_baptab, baptab, sizeof(g_baptab));
    memcpy(g_bndtab, bndtab, sizeof(g_bndtab));
    memcpy(g_bndsz, bndsz, sizeof(g_bndsz));
    memcpy(g_masktab, masktab, 253 * 4);
    memcpy(g_scale, scale, sizeof(g_scale));
    memcpy(g_q10, q10, sizeof(g_q10));  memcpy(g_q11, q11, sizeof(g_q11));
    memcpy(g_q12, q12, sizeof(g_q12));  memcpy(g_q20, q20, sizeof(g_q20));
    memcpy(g_q21, q21, sizeof(g_q21));  memcpy(g_q22, q22, sizeof(g_q22));
    memcpy(g_q3, q3, sizeof(g_q3));     memcpy(g_q40, q40, sizeof(g_q40));
    memcpy(g_q41, q41, sizeof(g_q41));  memcpy(g_q5, q5, sizeof(g_q5));
    memcpy(g_ditherlut, ditherlut, sizeof(g_ditherlut));
    memcpy(g_sdecay, sdecay, sizeof(g_sdecay));
    memcpy(g_fdecay, fdecay, sizeof(g_fdecay));
    memcpy(g_sgain, sgain, sizeof(g_sgain));
    memcpy(g_dbknee, dbknee, sizeof(g_dbknee));
    memcpy(g_floor, floortab, sizeof(g_floor));
    memcpy(g_fgain, fgain, sizeof(g_fgain));
    memcpy(g_exp1, exp1, sizeof(g_exp1));
    memcpy(g_exp2, exp2, sizeof(g_exp2));
    memcpy(g_exp3, exp3, sizeof(g_exp3));
    memcpy(g_cplbnd, cplbnd, sizeof(g_cplbnd));
    memcpy(g_bapbits, bapbits, sizeof(g_bapbits));
}

// ---------------------------------------------------------------------------
// bit reader (MSB-first)
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t* buf;
    int64_t pos;                      // bit position
    int64_t len = INT64_MAX;          // buffer length in bytes (clamps reads)

    inline uint32_t read(int n) {
        int64_t p = pos;
        pos += n;
        int64_t byte0 = p >> 3;
        if (byte0 + 8 <= len) {       // fast path: one unaligned 64-bit load
            uint64_t w;
            memcpy(&w, buf + byte0, 8);
            w = __builtin_bswap64(w);
            return (uint32_t)((w << (p & 7)) >> (64 - n));
        }
        // tail path: byte loop; bytes past the buffer read as zero (corrupt
        // frames whose side-info overruns the frame are rejected upstream)
        uint32_t acc = 0;
        int nbytes = (int)(((p & 7) + n + 7) >> 3);
        for (int i = 0; i < nbytes; i++) {
            uint8_t b = (byte0 + i < len) ? buf[byte0 + i] : 0;
            acc = (acc << 8) | b;
        }
        acc >>= (8 * nbytes - (p & 7) - n);
        return n >= 32 ? acc : (acc & ((1u << n) - 1));
    }
    inline int32_t read_signed(int n) {
        int32_t v = (int32_t)read(n);
        if (v >= (1 << (n - 1))) v -= (1 << n);
        return v;
    }
    inline void skip(int n) { pos += n; }
};

// ---------------------------------------------------------------------------
// spec-form parametric bit allocation (port of host/alloc.py)
// ---------------------------------------------------------------------------

static inline int logadd(int a, int b) {
    int c = a - b;
    int adr = (c >= 0 ? c : -c) >> 1;
    if (adr > 255) adr = 255;
    return (c >= 0 ? a : b) + g_latab[adr];
}

static inline int calc_lowcomp(int a, int b0, int b1, int bin) {
    if (bin < 7) {
        if (b0 + 256 == b1) return 384;
        if (b0 > b1) { a -= 64; return a < 0 ? 0 : a; }
        return a;
    }
    if (bin < 20) {
        if (b0 + 256 == b1) return 320;
        if (b0 > b1) { a -= 64; return a < 0 ? 0 : a; }
        return a;
    }
    a -= 128;
    return a < 0 ? 0 : a;
}

struct AllocParams {
    int sdecay, fdecay, sgain, dbknee, floorv;
    int fscod, halfratecod;
};

static void bit_allocate(const uint8_t* exp, int start, int end,
                         int snroffset, int fgain, const AllocParams& P,
                         bool is_lfe, int cplfleak, int cplsleak,
                         const int8_t* deltba, int8_t* bap)
{
    memset(bap, 0, 256);
    if (end <= start) return;
    int psd[256];
    for (int i = start; i < end; i++) psd[i] = 3072 - (exp[i] << 7);

    int bndstrt = g_masktab[start];
    int bndend = g_masktab[end - 1] + 1;
    int bndpsd[50] = {0};
    {
        int j = start;
        for (int k = bndstrt; k < bndend; k++) {
            int v = psd[j++];
            int lim = g_bndtab[k + 1] < end ? g_bndtab[k + 1] : end;
            while (j < lim) v = logadd(v, psd[j++]);
            bndpsd[k] = v;
        }
    }

    int excite[50] = {0};
    int fastleak = 0, slowleak = 0;
    int begin;
    if (bndstrt == 0) {
        int lowcomp = calc_lowcomp(0, bndpsd[0], bndpsd[1], 0);
        excite[0] = bndpsd[0] - fgain - lowcomp;
        lowcomp = calc_lowcomp(lowcomp, bndpsd[1], bndpsd[2], 1);
        excite[1] = bndpsd[1] - fgain - lowcomp;
        begin = 7;
        for (int b = 2; b < 7; b++) {
            if (!(is_lfe && b == 6))
                lowcomp = calc_lowcomp(lowcomp, bndpsd[b], bndpsd[b + 1], b);
            fastleak = bndpsd[b] - fgain;
            slowleak = bndpsd[b] - P.sgain;
            excite[b] = fastleak - lowcomp;
            if (!(is_lfe && b == 6) && bndpsd[b] <= bndpsd[b + 1]) {
                begin = b + 1;
                break;
            }
        }
        int end1 = bndend < 22 ? bndend : 22;
        for (int b = begin; b < end1; b++) {
            if (!(is_lfe && b == 6))
                lowcomp = calc_lowcomp(lowcomp, bndpsd[b], bndpsd[b + 1], b);
            fastleak -= P.fdecay;
            if (fastleak < bndpsd[b] - fgain) fastleak = bndpsd[b] - fgain;
            slowleak -= P.sdecay;
            if (slowleak < bndpsd[b] - P.sgain) slowleak = bndpsd[b] - P.sgain;
            int v = fastleak - lowcomp;
            if (slowleak > v) v = slowleak;
            excite[b] = v;
        }
        begin = 22;
    } else {
        begin = bndstrt;
        fastleak = (cplfleak << 8) + 768;
        slowleak = (cplsleak << 8) + 768;
    }
    for (int b = begin; b < bndend; b++) {
        fastleak -= P.fdecay;
        if (fastleak < bndpsd[b] - fgain) fastleak = bndpsd[b] - fgain;
        slowleak -= P.sdecay;
        if (slowleak < bndpsd[b] - P.sgain) slowleak = bndpsd[b] - P.sgain;
        excite[b] = fastleak > slowleak ? fastleak : slowleak;
    }

    int mask[50];
    for (int b = bndstrt; b < bndend; b++) {
        int v1 = excite[b];
        int tmp = P.dbknee - bndpsd[b];
        if (tmp > 0) v1 += tmp >> 2;
        int h = g_hth[b >> P.halfratecod][P.fscod];
        mask[b] = v1 > h ? v1 : h;
        if (deltba) mask[b] += ((int)deltba[b]) << 7;
    }

    int i = start;
    for (int k = bndstrt; k < bndend; k++) {
        int v = mask[k] - snroffset - P.floorv;
        if (v < 0) v = 0;
        v = (v & 0x1FE0) + P.floorv;
        int lim = g_bndtab[k] + g_bndsz[k];
        if (lim > end) lim = end;
        for (; i < lim; i++) {
            int address = (psd[i] - v) >> 5;
            if (address < 0) address = 0;
            else if (address > 63) address = 63;
            bap[i] = g_baptab[address];
        }
    }
}

// ---------------------------------------------------------------------------
// downmix negotiation & coefficients (decode semantics of downmix.c)
// ---------------------------------------------------------------------------

static const double LEVEL_3DB_D = 0.7071067811865476;
static const double LEVEL_45DB_D = 0.5946035575013605;
static const double LEVEL_P3DB_D = 1.4142135623730951;

static const uint8_t DM_TABLE[11][8] = {
    {A52_CHANNEL, A52_DOLBY, A52_STEREO, A52_STEREO, A52_STEREO, A52_STEREO, A52_STEREO, A52_STEREO},
    {A52_MONO, A52_MONO, A52_MONO, A52_MONO, A52_MONO, A52_MONO, A52_MONO, A52_MONO},
    {A52_CHANNEL, A52_DOLBY, A52_STEREO, A52_STEREO, A52_STEREO, A52_STEREO, A52_STEREO, A52_STEREO},
    {A52_CHANNEL, A52_DOLBY, A52_STEREO, A52_3F, A52_STEREO, A52_3F, A52_STEREO, A52_3F},
    {A52_CHANNEL, A52_DOLBY, A52_STEREO, A52_STEREO, A52_2F1R, A52_2F1R, A52_2F1R, A52_2F1R},
    {A52_CHANNEL, A52_DOLBY, A52_STEREO, A52_STEREO, A52_2F1R, A52_3F1R, A52_2F1R, A52_3F1R},
    {A52_CHANNEL, A52_DOLBY, A52_STEREO, A52_3F, A52_2F2R, A52_2F2R, A52_2F2R, A52_2F2R},
    {A52_CHANNEL, A52_DOLBY, A52_STEREO, A52_3F, A52_2F2R, A52_3F2R, A52_2F2R, A52_3F2R},
    {A52_CHANNEL1, A52_MONO, A52_MONO, A52_MONO, A52_MONO, A52_MONO, A52_MONO, A52_MONO},
    {A52_CHANNEL2, A52_MONO, A52_MONO, A52_MONO, A52_MONO, A52_MONO, A52_MONO, A52_MONO},
    {A52_CHANNEL, A52_DOLBY, A52_STEREO, A52_DOLBY, A52_DOLBY, A52_DOLBY, A52_DOLBY, A52_DOLBY},
};

#define CVT(a, b) (((b) << 3) + (a))

static int downmix_init(int input, int flags, float* level,
                        float clev, float slev)
{
    int output = flags & A52_CHANNEL_MASK;
    if (output > A52_DOLBY) return -1;
    output = DM_TABLE[output][input & 7];
    // float-vs-double comparison exactly as the reference writes it
    // (downmix.c:70): never true for a parsed f32 clev in the float build
    if (output == A52_STEREO &&
        (input == A52_DOLBY ||
         (input == A52_3F && (double)clev == LEVEL_3DB_D)))
        output = A52_DOLBY;

    if (flags & A52_ADJUST_LEVEL) {
        // Exact type replay of the reference's DIV()/LEVEL() macros
        // (downmix.c:73-157): float division where all operands are float,
        // double where a double literal promotes, float inner sums.
        float c = clev, s = slev;
        float adjust;
        bool have = true;
        switch (CVT(input & 7, output)) {
        case CVT(A52_3F, A52_MONO):
            adjust = (float)(LEVEL_3DB_D / (1.0f + c)); break;
        case CVT(A52_STEREO, A52_MONO):
        case CVT(A52_2F2R, A52_2F1R):
        case CVT(A52_3F2R, A52_3F1R):
            adjust = (float)LEVEL_3DB_D; break;
        case CVT(A52_3F2R, A52_2F1R):
            if (c < (float)(LEVEL_P3DB_D - 1.0)) {
                adjust = (float)LEVEL_3DB_D; break;
            }
            adjust = 1.0f / (1.0f + c); break;           // float division
        case CVT(A52_3F, A52_STEREO):
        case CVT(A52_3F1R, A52_2F1R):
        case CVT(A52_3F1R, A52_2F2R):
        case CVT(A52_3F2R, A52_2F2R):
            adjust = 1.0f / (1.0f + c); break;           // float division
        case CVT(A52_2F1R, A52_MONO):
            adjust = (float)(LEVEL_P3DB_D / (2.0f + s)); break;
        case CVT(A52_2F1R, A52_STEREO):
        case CVT(A52_3F1R, A52_3F):
            adjust = (float)(1.0 / (1.0 + s * LEVEL_3DB_D)); break;
        case CVT(A52_3F1R, A52_MONO):
            adjust = (float)(LEVEL_3DB_D / ((1.0f + c) + s * 0.5)); break;
        case CVT(A52_3F1R, A52_STEREO):
            adjust = (float)(1.0 / ((1.0f + c) + s * LEVEL_3DB_D)); break;
        case CVT(A52_2F2R, A52_MONO):
            adjust = (float)(LEVEL_3DB_D / (1.0f + s)); break;
        case CVT(A52_2F2R, A52_STEREO):
        case CVT(A52_3F2R, A52_3F):
            adjust = 1.0f / (1.0f + s); break;           // float division
        case CVT(A52_3F2R, A52_MONO):
            adjust = (float)(LEVEL_3DB_D / (1.0f + c + s)); break;
        case CVT(A52_3F2R, A52_STEREO):
            adjust = 1.0f / (1.0f + c + s); break;       // float division
        case CVT(A52_MONO, A52_DOLBY):
            adjust = (float)LEVEL_P3DB_D; break;
        case CVT(A52_3F, A52_DOLBY):
        case CVT(A52_2F1R, A52_DOLBY):
            adjust = (float)(1.0 / (1.0 + LEVEL_3DB_D)); break;
        case CVT(A52_3F1R, A52_DOLBY):
        case CVT(A52_2F2R, A52_DOLBY):
            adjust = (float)(1.0 / (1.0 + 2.0 * LEVEL_3DB_D)); break;
        case CVT(A52_3F2R, A52_DOLBY):
            adjust = (float)(1.0 / (1.0 + 3.0 * LEVEL_3DB_D)); break;
        default: have = false; break;
        }
        if (have) *level = *level * adjust;
    }
    return output;
}

// coeff[5] + chanbias; float32 semantics with double-constant promotions
static int downmix_coeff(float* coeff, int acmod, int output, float level,
                         float clev, float slev)
{
    float lvl3 = (float)((double)level * LEVEL_3DB_D);
    for (int i = 0; i < 5; i++) coeff[i] = 0.0f;
    auto mul = [](float a, float b) { return a * b; };
    switch (CVT(acmod, output & A52_CHANNEL_MASK)) {
    case CVT(A52_CHANNEL, A52_CHANNEL): case CVT(A52_MONO, A52_MONO):
    case CVT(A52_STEREO, A52_STEREO): case CVT(A52_3F, A52_3F):
    case CVT(A52_2F1R, A52_2F1R): case CVT(A52_3F1R, A52_3F1R):
    case CVT(A52_2F2R, A52_2F2R): case CVT(A52_3F2R, A52_3F2R):
    case CVT(A52_STEREO, A52_DOLBY):
        coeff[0] = coeff[1] = coeff[2] = coeff[3] = coeff[4] = level;
        return 0;
    case CVT(A52_CHANNEL, A52_MONO):
        coeff[0] = coeff[1] = (float)((double)level * 0.5);
        return 3;
    case CVT(A52_STEREO, A52_MONO):
        coeff[0] = coeff[1] = lvl3;
        return 3;
    case CVT(A52_3F, A52_MONO):
        coeff[0] = coeff[2] = lvl3;
        coeff[1] = (float)((double)mul(lvl3, clev) * 2.0);
        return 7;
    case CVT(A52_2F1R, A52_MONO):
        coeff[0] = coeff[1] = lvl3;
        coeff[2] = mul(lvl3, slev);
        return 7;
    case CVT(A52_2F2R, A52_MONO):
        coeff[0] = coeff[1] = lvl3;
        coeff[2] = coeff[3] = mul(lvl3, slev);
        return 15;
    case CVT(A52_3F1R, A52_MONO):
        coeff[0] = coeff[2] = lvl3;
        coeff[1] = (float)((double)mul(lvl3, clev) * 2.0);
        coeff[3] = mul(lvl3, slev);
        return 15;
    case CVT(A52_3F2R, A52_MONO):
        coeff[0] = coeff[2] = lvl3;
        coeff[1] = (float)((double)mul(lvl3, clev) * 2.0);
        coeff[3] = coeff[4] = mul(lvl3, slev);
        return 31;
    case CVT(A52_MONO, A52_DOLBY):
        coeff[0] = lvl3;
        return 0;
    case CVT(A52_3F, A52_DOLBY):
        coeff[0] = coeff[2] = coeff[3] = coeff[4] = level;
        coeff[1] = lvl3;
        return 7;
    case CVT(A52_3F, A52_STEREO): case CVT(A52_3F1R, A52_2F1R):
    case CVT(A52_3F2R, A52_2F2R):
        coeff[0] = coeff[2] = coeff[3] = coeff[4] = level;
        coeff[1] = mul(level, clev);
        return 7;
    case CVT(A52_2F1R, A52_DOLBY):
        coeff[0] = coeff[1] = level;
        coeff[2] = lvl3;
        return 7;
    case CVT(A52_2F1R, A52_STEREO):
        coeff[0] = coeff[1] = level;
        coeff[2] = mul(lvl3, slev);
        return 7;
    case CVT(A52_3F1R, A52_DOLBY):
        coeff[0] = coeff[2] = level;
        coeff[1] = coeff[3] = lvl3;
        return 15;
    case CVT(A52_3F1R, A52_STEREO):
        coeff[0] = coeff[2] = level;
        coeff[1] = mul(level, clev);
        coeff[3] = mul(lvl3, slev);
        return 15;
    case CVT(A52_2F2R, A52_DOLBY):
        coeff[0] = coeff[1] = level;
        coeff[2] = coeff[3] = lvl3;
        return 15;
    case CVT(A52_2F2R, A52_STEREO):
        coeff[0] = coeff[1] = level;
        coeff[2] = coeff[3] = mul(level, slev);
        return 15;
    case CVT(A52_3F2R, A52_DOLBY):
        coeff[0] = coeff[2] = level;
        coeff[1] = coeff[3] = coeff[4] = lvl3;
        return 31;
    case CVT(A52_3F2R, A52_2F1R):
        coeff[0] = coeff[2] = level;
        coeff[1] = mul(level, clev);
        coeff[3] = coeff[4] = lvl3;
        return 31;
    case CVT(A52_3F2R, A52_STEREO):
        coeff[0] = coeff[2] = level;
        coeff[1] = mul(level, clev);
        coeff[3] = coeff[4] = mul(level, slev);
        return 31;
    case CVT(A52_3F1R, A52_3F):
        coeff[0] = coeff[1] = coeff[2] = level;
        coeff[3] = mul(lvl3, slev);
        return 13;
    case CVT(A52_3F2R, A52_3F):
        coeff[0] = coeff[1] = coeff[2] = level;
        coeff[3] = coeff[4] = mul(level, slev);
        return 29;
    case CVT(A52_2F2R, A52_2F1R):
        coeff[0] = coeff[1] = level;
        coeff[2] = coeff[3] = lvl3;
        return 12;
    case CVT(A52_3F2R, A52_3F1R):
        coeff[0] = coeff[1] = coeff[2] = level;
        coeff[3] = coeff[4] = lvl3;
        return 24;
    case CVT(A52_2F1R, A52_2F2R):
        coeff[0] = coeff[1] = level;
        coeff[2] = lvl3;
        return 0;
    case CVT(A52_3F1R, A52_2F2R):
        coeff[0] = coeff[2] = level;
        coeff[1] = mul(level, clev);
        coeff[3] = lvl3;
        return 7;
    case CVT(A52_3F1R, A52_3F2R):
        coeff[0] = coeff[1] = coeff[2] = level;
        coeff[3] = lvl3;
        return 0;
    case CVT(A52_CHANNEL, A52_CHANNEL1):
        coeff[0] = level;
        return 0;
    case CVT(A52_CHANNEL, A52_CHANNEL2):
        coeff[1] = level;
        return 0;
    }
    return -1;
}

// ---------------------------------------------------------------------------
// parser state + per-frame outputs
// ---------------------------------------------------------------------------

struct ChannelBA {
    int bai;
    int deltbae;
    int8_t deltba[50];
};

typedef float (*dynrng_cb)(float, void*);

// Raw-H2D side-info record, one per block: the exact wire layout the
// device unpack consumes (ops/unpack_device.py _META_WIRE_DTYPES; numpy
// structured-dtype mirror in host/native.py RAW_REC_DTYPE).  Bit offsets
// are frame-relative; -1 = field absent this block.
#pragma pack(push, 1)
struct RawRecWire {
    int16_t exp_off[7];          // 0-4 fbw, 5 cpl, 6 lfe
    int8_t expstr[7];
    int8_t ngrps[7];
    int16_t cplco_off[5];
    int16_t phs_off;
    int16_t man_off;
    int16_t endmant[5];
    int8_t chincpl;
    int8_t phsflginu;
    int16_t cplstrt;
    int16_t cplend;
    int32_t cplbndstrc;
    int8_t ncplbnd;
    int8_t cplstrtbnd;
    int16_t bai;
    int8_t csnroffst;
    int8_t cplbai;
    int8_t babai[5];
    int8_t lfebai;
    int8_t cplfleak;
    int8_t cplsleak;
    int8_t dith[5];
    int8_t blksw[5];
    float coeff[5];
    int8_t chanbias;
    int8_t rematflg;
    float lfe_scale;
    int8_t lfeon;
    int8_t lfe_out;
    int8_t fscod;
    int8_t halfrate;
    int8_t deltba[7][50];
};
#pragma pack(pop)

struct Parser {
    int fscod, halfrate, acmod, lfeon, output;
    float clev, slev, level, bias, dynrng;
    int dynrnge;
    dynrng_cb dyncall;
    void* dyndata;
    int chincpl, phsflginu;
    int cplstrtmant, cplendmant, cplstrtbnd, ncplbnd;
    uint32_t cplbndstrc;
    float cplco[5][18];
    uint32_t rematflg;
    int endmant[5];
    int bai;
    int csnroffst;
    ChannelBA cplba, ba[5], lfeba;
    int cplfleak, cplsleak;
    uint8_t cpl_exp[256];
    int8_t cpl_bap[256];
    uint8_t fbw_exp[5][256];
    int8_t fbw_bap[5][256];
    uint8_t lfe_exp[7];
    int8_t lfe_bap[7];
    uint16_t lfsr;
    // deltba in effect at each row's LAST bit allocation (fbw 0-4, cpl 5):
    // bap caches across blocks, so the raw-H2D meta must ship the
    // cached-alloc inputs (mirrors host/parse.py DecoderState.eff_deltba)
    int8_t eff_deltba[7][50];
    // side-info-only parse mode: when set, parse_block records bit
    // offsets + resolved side-info into rec_base[blk] and skips the
    // mantissa walk (the device unpacks mantissas itself)
    RawRecWire* rec_base;
};

// per-frame dense output block: caller-allocated, layout mirrors the Python
// BlockData stacking
struct FrameOut {
    float q[6][6][256];
    float a[6][6][256];
    float b[6][6][256];
    uint8_t blksw[6][5];
    float coeff[6][5];
    uint8_t remat[6][256];
    int32_t chanbias;
    int32_t acmod, lfeon, output, nfchans;
    float slev, bias;
};

extern "C" Parser* ac3h_new() {
    Parser* p = new Parser();
    memset(p, 0, sizeof(Parser));
    p->lfsr = 1;
    p->dynrnge = 1;
    return p;
}
extern "C" void ac3h_free(Parser* p) { delete p; }
extern "C" void ac3h_set_drc(Parser* p, int enabled) { p->dynrnge = enabled; }
// a52_dynrng callback parity (liba52 parse.c:207-216,593-594): the user hook
// remaps the decoded range before it scales the level
extern "C" void ac3h_set_dynrng_call(Parser* p, dynrng_cb cb, void* data) {
    p->dyncall = cb;
    p->dyndata = data;
    if (cb) p->dynrnge = 1;
}

static inline float dither_gen(Parser* s) {
    uint16_t nstate = (uint16_t)(g_ditherlut[s->lfsr >> 8] ^ (s->lfsr << 8));
    s->lfsr = nstate;
    return (float)((3 * (int)(int16_t)nstate) >> 2);
}

struct QuantSet {
    float q1[2], q2[2], q4;
    int q1_ptr, q2_ptr, q4_ptr;
};

// Coefficient sinks: the mantissa walk emits (value, factor, multiplier)
// triples; QabSink stores the factorization for the device pipeline's
// (q*a)*b dequant, FreqSink performs the identical IEEE f32 dequant
// in place (used by the dense end-to-end path to halve memory traffic).
struct QabSink {
    FrameOut* fo;
    inline void put(int blk, int ch, int i, float v, float fac, float mul) {
        fo->q[blk][ch][i] = v;
        fo->a[blk][ch][i] = fac;
        fo->b[blk][ch][i] = mul;
    }
};
struct FreqSink {
    float* base;                     // [6 blocks][6 ch][256]
    inline void put(int blk, int ch, int i, float v, float fac, float mul) {
        base[((int64_t)blk * 6 + ch) * 256 + i] = (v * fac) * mul;
    }
};
struct DropSink {
    inline void put(int, int, int, float, float, float) {}
};

template <class SINK>
static void coeff_get(Parser* s, BitReader& br, SINK& sink, int blk, int ch,
                      const uint8_t* exp, const int8_t* bap, float level,
                      int dither, int end, QuantSet& qs)
{
    float factor[25];
    for (int i = 0; i <= 24; i++) factor[i] = g_scale[i] * level;
    for (int i = 0; i < end; i++) {
        int bp = bap[i];
        float v;
        switch (bp) {
        case 0:
            if (dither)
                sink.put(blk, ch, i, dither_gen(s), factor[exp[i]], 1.0f);
            continue;
        case 1:
            if (qs.q1_ptr >= 0) v = qs.q1[qs.q1_ptr--];
            else {
                int code = br.read(5);
                qs.q1_ptr = 1;
                qs.q1[0] = g_q12[code];
                qs.q1[1] = g_q11[code];
                v = g_q10[code];
            }
            break;
        case 2:
            if (qs.q2_ptr >= 0) v = qs.q2[qs.q2_ptr--];
            else {
                int code = br.read(7);
                qs.q2_ptr = 1;
                qs.q2[0] = g_q22[code];
                qs.q2[1] = g_q21[code];
                v = g_q20[code];
            }
            break;
        case 3: v = g_q3[br.read(3)]; break;
        case 4:
            if (qs.q4_ptr == 0) { qs.q4_ptr = -1; v = qs.q4; }
            else {
                int code = br.read(7);
                qs.q4_ptr = 0;
                qs.q4 = g_q41[code];
                v = g_q40[code];
            }
            break;
        case 5: v = g_q5[br.read(4)]; break;
        default: {
            int nbits = g_bapbits[bp];
            v = (float)(br.read_signed(nbits) << (16 - nbits));
        }
        }
        sink.put(blk, ch, i, v, factor[exp[i]], 1.0f);
    }
}

template <class SINK>
static void coeff_get_coupling(Parser* s, BitReader& br, SINK& sink,
                               int blk, int nfchans, const float* coeff,
                               const uint8_t* dithflag, QuantSet& qs)
{
    const uint8_t* exp = s->cpl_exp;
    const int8_t* bap = s->cpl_bap;
    float cplco[5];
    int i = s->cplstrtmant;
    int bnd = 0;
    uint32_t strc = s->cplbndstrc;
    while (i < s->cplendmant) {
        int i_end = i + 12;
        while (strc & 1) { strc >>= 1; i_end += 12; }
        strc >>= 1;
        for (int ch = 0; ch < nfchans; ch++)
            cplco[ch] = s->cplco[ch][bnd] * coeff[ch];
        bnd++;
        for (; i < i_end; i++) {
            int bp = bap[i];
            float v;
            if (bp == 0) {
                for (int ch = 0; ch < nfchans; ch++)
                    if ((s->chincpl >> ch) & 1 && dithflag[ch])
                        sink.put(blk, ch, i, dither_gen(s),
                                 g_scale[exp[i]] * cplco[ch], 1.0f);
                continue;
            }
            switch (bp) {
            case 1:
                if (qs.q1_ptr >= 0) v = qs.q1[qs.q1_ptr--];
                else {
                    int code = br.read(5);
                    qs.q1_ptr = 1;
                    qs.q1[0] = g_q12[code];
                    qs.q1[1] = g_q11[code];
                    v = g_q10[code];
                }
                break;
            case 2:
                if (qs.q2_ptr >= 0) v = qs.q2[qs.q2_ptr--];
                else {
                    int code = br.read(7);
                    qs.q2_ptr = 1;
                    qs.q2[0] = g_q22[code];
                    qs.q2[1] = g_q21[code];
                    v = g_q20[code];
                }
                break;
            case 3: v = g_q3[br.read(3)]; break;
            case 4:
                if (qs.q4_ptr == 0) { qs.q4_ptr = -1; v = qs.q4; }
                else {
                    int code = br.read(7);
                    qs.q4_ptr = 0;
                    qs.q4 = g_q41[code];
                    v = g_q40[code];
                }
                break;
            case 5: v = g_q5[br.read(4)]; break;
            default: {
                int nbits = g_bapbits[bp];
                v = (float)(br.read_signed(nbits) << (16 - nbits));
            }
            }
            for (int ch = 0; ch < nfchans; ch++)
                if ((s->chincpl >> ch) & 1)
                    sink.put(blk, ch, i, v, g_scale[exp[i]], cplco[ch]);
        }
    }
}

static int parse_exponents(BitReader& br, int expstr, int ngrps,
                           int exponent, uint8_t* dest)
{
    int fan = expstr == 1 ? 1 : (expstr == 2 ? 2 : 4);
    while (ngrps--) {
        int exps = br.read(7);
        const int8_t* tabs[3] = {g_exp1, g_exp2, g_exp3};
        for (int t = 0; t < 3; t++) {
            // uint8_t accumulator in the reference (parse.c:218-231):
            // negative-going deltas wrap to ~255 and fail the range check
            exponent = (exponent + tabs[t][exps]) & 0xFF;
            if (exponent > 24) return 1;
            for (int f = 0; f < fan; f++) *dest++ = (uint8_t)exponent;
        }
    }
    return 0;
}

static int parse_deltba(BitReader& br, int8_t* deltba) {
    memset(deltba, 0, 50);
    int deltnseg = br.read(3);
    int j = 0;
    do {
        j += br.read(5);
        int deltlen = br.read(4);
        int delta = br.read(3);
        delta -= (delta >= 4) ? 3 : 4;
        if (!deltlen) continue;
        if (j + deltlen >= 50) return 1;
        while (deltlen--) deltba[j++] = (int8_t)delta;
    } while (deltnseg--);
    return 0;
}

static int zero_snr_offsets(Parser* s, int nfchans) {
    if (s->csnroffst) return 0;
    if (s->chincpl && (s->cplba.bai >> 3)) return 0;
    if (s->lfeon && (s->lfeba.bai >> 3)) return 0;
    for (int i = 0; i < nfchans; i++)
        if (s->ba[i].bai >> 3) return 0;
    return 1;
}

// null side-info record: csnroffst 0 with all bai clear rides the
// zero-SNR shortcut, so the device emits silence for the block (must
// match ops/unpack_device.py null_raw_rec exactly)
static void raw_rec_null(RawRecWire* rc) {
    memset(rc, 0, sizeof(*rc));
    for (int i = 0; i < 7; i++) rc->exp_off[i] = -1;
    for (int i = 0; i < 5; i++) rc->cplco_off[i] = -1;
    rc->phs_off = -1;
    rc->cplstrt = 37;
    rc->cplend = 37;
}

// total bit width of the block's mantissa field: the coded-order lattice
// (fbw channels with the coupling walk spliced after the first coupled
// channel, LFE last) with the grouped-quantizer carries (bap 1/2/4 read
// a code only at draw 0 mod 3/3/2 across the whole block) -- mirrors
// host/parse.py _mantissa_bits and ops.unpack_device's width model
static int mantissa_bits(Parser* s, int nfchans) {
    int c1 = 0, c2 = 0, c4 = 0, bits = 0;
    auto row = [&](const int8_t* bap, int start, int end) {
        for (int i = start; i < end; i++) {
            switch (bap[i]) {
            case 0: break;
            case 1: if (c1 == 0) bits += 5; c1 = (c1 + 1) % 3; break;
            case 2: if (c2 == 0) bits += 7; c2 = (c2 + 1) % 3; break;
            case 3: bits += 3; break;
            case 4: if (c4 == 0) bits += 7; c4 ^= 1; break;
            case 5: bits += 4; break;
            default: bits += g_bapbits[(int)bap[i]];
            }
        }
    };
    int done_cpl = 0;
    for (int i = 0; i < nfchans; i++) {
        row(s->fbw_bap[i], 0, s->endmant[i]);
        if (((s->chincpl >> i) & 1) && !done_cpl) {
            done_cpl = 1;
            row(s->cpl_bap, s->cplstrtmant, s->cplendmant);
        }
    }
    if (s->lfeon) row(s->lfe_bap, 0, 7);
    return bits;
}

template <class SINK>
static int parse_block(Parser* s, BitReader& br, FrameOut* out, int blk,
                       SINK& sink)
{
    int nfchans = NFCHANS_TBL[s->acmod];
    RawRecWire* rc = s->rec_base ? s->rec_base + blk : nullptr;
    if (rc) raw_rec_null(rc);
    uint8_t blksw[5] = {0}, dithflag[5] = {0};
    for (int i = 0; i < nfchans; i++) blksw[i] = br.read(1);
    for (int i = 0; i < nfchans; i++) dithflag[i] = br.read(1);
    memcpy(out->blksw[blk], blksw, 5);

    for (int ci = 0; ci <= (s->acmod == 0 ? 1 : 0); ci++) {
        if (br.read(1)) {
            int dynrng = br.read_signed(8);
            if (s->dynrnge) {
                float range = (float)(((dynrng & 0x1F) | 0x20) << 13)
                              * g_scale[3 - (dynrng >> 5)];
                if (s->dyncall) range = s->dyncall(range, s->dyndata);
                s->dynrng = s->level * range;
            }
        }
    }

    if (br.read(1)) {                       // cplstre
        s->chincpl = 0;
        if (br.read(1)) {                   // cplinu
            for (int i = 0; i < nfchans; i++)
                s->chincpl |= br.read(1) << i;
            if (s->acmod == 0 || s->acmod == 1) return 1;
            if (s->acmod == 2) s->phsflginu = br.read(1);
            int cplbegf = br.read(4);
            int cplendf = br.read(4);
            if (cplendf + 3 - cplbegf < 0) return 1;
            int ncplsubnd = cplendf + 3 - cplbegf;
            s->ncplbnd = ncplsubnd;
            s->cplstrtbnd = g_cplbnd[cplbegf];
            s->cplstrtmant = cplbegf * 12 + 37;
            s->cplendmant = cplendf * 12 + 73;
            s->cplbndstrc = 0;
            for (int i = 0; i < ncplsubnd - 1; i++)
                if (br.read(1)) { s->cplbndstrc |= 1u << i; s->ncplbnd--; }
        }
    }

    if (s->chincpl) {
        int cplcoe = 0;
        for (int i = 0; i < nfchans; i++)
            if ((s->chincpl >> i) & 1 && br.read(1)) {
                cplcoe = 1;
                if (rc) rc->cplco_off[i] = (int16_t)br.pos;
                int mstr = 3 * br.read(2);
                for (int j = 0; j < s->ncplbnd; j++) {
                    int cexp = br.read(4);
                    int cmant = br.read(4);
                    if (cexp == 15) cmant <<= 14;
                    else cmant = (cmant | 0x10) << 13;
                    s->cplco[i][j] = (float)cmant * g_scale[cexp + mstr];
                }
            }
        if (s->acmod == 2 && s->phsflginu && cplcoe) {
            if (rc) rc->phs_off = (int16_t)br.pos;
            for (int j = 0; j < s->ncplbnd; j++)
                if (br.read(1)) s->cplco[1][j] = -s->cplco[1][j];
        }
    }

    if (s->acmod == 2 && br.read(1)) {      // rematstr
        s->rematflg = 0;
        int end = s->chincpl ? s->cplstrtmant : 253;
        int i = 0;
        do
            s->rematflg |= br.read(1) << i;
        while (REMATRIX_BAND[i++] < end);
    }

    int cplexpstr = EXP_REUSE, lfeexpstr = EXP_REUSE;
    int chexpstr[5];
    if (s->chincpl) cplexpstr = br.read(2);
    for (int i = 0; i < nfchans; i++) chexpstr[i] = br.read(2);
    if (s->lfeon) lfeexpstr = br.read(1);

    for (int i = 0; i < nfchans; i++)
        if (chexpstr[i] != EXP_REUSE) {
            if ((s->chincpl >> i) & 1) s->endmant[i] = s->cplstrtmant;
            else {
                int chbwcod = br.read(6);
                if (chbwcod > 60) return 1;
                s->endmant[i] = chbwcod * 3 + 73;
            }
        }

    int do_bit_alloc = 0;
    if (cplexpstr != EXP_REUSE) {
        do_bit_alloc = 64;
        int ncplgrps = (s->cplendmant - s->cplstrtmant) / (3 << (cplexpstr - 1));
        if (rc) {
            rc->exp_off[5] = (int16_t)br.pos;
            rc->expstr[5] = (int8_t)cplexpstr;
            rc->ngrps[5] = (int8_t)ncplgrps;
        }
        int cplabsexp = br.read(4) << 1;
        if (parse_exponents(br, cplexpstr, ncplgrps, cplabsexp,
                            s->cpl_exp + s->cplstrtmant))
            return 1;
    }
    for (int i = 0; i < nfchans; i++)
        if (chexpstr[i] != EXP_REUSE) {
            do_bit_alloc |= 1 << i;
            int grp = 3 << (chexpstr[i] - 1);
            int nchgrps = (s->endmant[i] + grp - 4) / grp;
            if (rc) {
                rc->exp_off[i] = (int16_t)br.pos;
                rc->expstr[i] = (int8_t)chexpstr[i];
                rc->ngrps[i] = (int8_t)nchgrps;
            }
            s->fbw_exp[i][0] = br.read(4);
            if (parse_exponents(br, chexpstr[i], nchgrps, s->fbw_exp[i][0],
                                s->fbw_exp[i] + 1))
                return 1;
            br.skip(2);
        }
    if (s->lfeon && lfeexpstr != EXP_REUSE) {
        do_bit_alloc |= 32;
        if (rc) {
            rc->exp_off[6] = (int16_t)br.pos;
            rc->expstr[6] = 1;                 // EXP_D15
            rc->ngrps[6] = 2;
        }
        s->lfe_exp[0] = br.read(4);
        uint8_t tmp[24];
        if (parse_exponents(br, 1, 2, s->lfe_exp[0], tmp)) return 1;
        memcpy(s->lfe_exp + 1, tmp, 6);
    }

    if (br.read(1)) { do_bit_alloc = 127; s->bai = br.read(11); }
    if (br.read(1)) {
        do_bit_alloc = 127;
        s->csnroffst = br.read(6);
        if (s->chincpl) s->cplba.bai = br.read(7);
        for (int i = 0; i < nfchans; i++) s->ba[i].bai = br.read(7);
        if (s->lfeon) s->lfeba.bai = br.read(7);
    }
    if (s->chincpl && br.read(1)) {
        do_bit_alloc |= 64;
        s->cplfleak = br.read(3);
        s->cplsleak = br.read(3);
    }
    if (br.read(1)) {
        do_bit_alloc = 127;
        if (s->chincpl) s->cplba.deltbae = br.read(2);
        for (int i = 0; i < nfchans; i++) s->ba[i].deltbae = br.read(2);
        if (s->chincpl && s->cplba.deltbae == DELTA_BIT_NEW
            && parse_deltba(br, s->cplba.deltba))
            return 1;
        for (int i = 0; i < nfchans; i++)
            if (s->ba[i].deltbae == DELTA_BIT_NEW
                && parse_deltba(br, s->ba[i].deltba))
                return 1;
    }

    if (do_bit_alloc) {
        AllocParams P;
        P.sdecay = g_sdecay[(s->bai >> 9) & 3] >> s->halfrate;
        P.fdecay = g_fdecay[(s->bai >> 7) & 3] >> s->halfrate;
        P.sgain = g_sgain[(s->bai >> 5) & 3];
        P.dbknee = g_dbknee[(s->bai >> 3) & 3];
        P.floorv = g_floor[s->bai & 7];
        P.fscod = s->fscod;
        P.halfratecod = s->halfrate;
        if (zero_snr_offsets(s, nfchans)) {
            memset(s->cpl_bap, 0, 256);
            for (int i = 0; i < nfchans; i++) memset(s->fbw_bap[i], 0, 256);
            memset(s->lfe_bap, 0, 7);
        } else {
            auto snro = [&](int bai7) {
                return ((((s->csnroffst - 15) << 4) + (bai7 >> 3)) << 2);
            };
            if (s->chincpl && (do_bit_alloc & 64)) {
                if (s->cplba.deltbae != DELTA_BIT_NONE)
                    memcpy(s->eff_deltba[5], s->cplba.deltba, 50);
                else
                    memset(s->eff_deltba[5], 0, 50);
                bit_allocate(s->cpl_exp, s->cplstrtmant, s->cplendmant,
                             snro(s->cplba.bai), g_fgain[s->cplba.bai & 7], P,
                             false, s->cplfleak, s->cplsleak,
                             s->cplba.deltbae != DELTA_BIT_NONE
                                 ? s->cplba.deltba : nullptr,
                             s->cpl_bap);
            }
            for (int i = 0; i < nfchans; i++)
                if (do_bit_alloc & (1 << i)) {
                    if (s->ba[i].deltbae != DELTA_BIT_NONE)
                        memcpy(s->eff_deltba[i], s->ba[i].deltba, 50);
                    else
                        memset(s->eff_deltba[i], 0, 50);
                    bit_allocate(s->fbw_exp[i], 0, s->endmant[i],
                                 snro(s->ba[i].bai), g_fgain[s->ba[i].bai & 7],
                                 P, false, 0, 0,
                                 s->ba[i].deltbae != DELTA_BIT_NONE
                                     ? s->ba[i].deltba : nullptr,
                                 s->fbw_bap[i]);
                }
            if (s->lfeon && (do_bit_alloc & 32)) {
                s->lfeba.deltbae = DELTA_BIT_NONE;
                uint8_t e[256] = {0};
                int8_t bp[256];
                memcpy(e, s->lfe_exp, 7);
                bit_allocate(e, 0, 7, snro(s->lfeba.bai),
                             g_fgain[s->lfeba.bai & 7], P, true, 0, 0,
                             nullptr, bp);
                memcpy(s->lfe_bap, bp, 7);
            }
        }
    }

    if (br.read(1)) {                        // skiple
        int n = br.read(9);
        br.skip(8 * n);
    }

    float coeff[5];
    int chanbias = downmix_coeff(coeff, s->acmod, s->output, s->dynrng,
                                 s->clev, s->slev);
    memcpy(out->coeff[blk], coeff, sizeof(coeff));
    out->chanbias = chanbias;

    if (rc) {
        // side-info-only mode: record the resolved (post-REUSE) state the
        // device allocator needs, then jump the cursor over the mantissa
        // field (host/parse.py _block's rec.update + _mantissa_bits)
        rc->man_off = (int16_t)br.pos;
        for (int i = 0; i < 5; i++)
            rc->endmant[i] = (int16_t)(i < nfchans ? s->endmant[i] : 0);
        rc->chincpl = (int8_t)s->chincpl;
        rc->phsflginu = (int8_t)s->phsflginu;
        rc->cplstrt = (int16_t)s->cplstrtmant;
        rc->cplend = (int16_t)s->cplendmant;
        rc->cplbndstrc = (int32_t)s->cplbndstrc;
        rc->ncplbnd = (int8_t)s->ncplbnd;
        rc->cplstrtbnd = (int8_t)s->cplstrtbnd;
        rc->bai = (int16_t)s->bai;
        rc->csnroffst = (int8_t)s->csnroffst;
        rc->cplbai = (int8_t)s->cplba.bai;
        for (int i = 0; i < 5; i++) rc->babai[i] = (int8_t)s->ba[i].bai;
        rc->lfebai = (int8_t)s->lfeba.bai;
        rc->cplfleak = (int8_t)s->cplfleak;
        rc->cplsleak = (int8_t)s->cplsleak;
        for (int i = 0; i < 5; i++) {
            rc->dith[i] = (int8_t)dithflag[i];
            rc->blksw[i] = (int8_t)blksw[i];
        }
        memcpy(rc->coeff, coeff, sizeof(coeff));
        rc->chanbias = (int8_t)chanbias;
        rc->rematflg = (int8_t)(s->acmod == 2 ? s->rematflg : 0);
        rc->lfe_scale = s->dynrng;
        rc->lfeon = (int8_t)s->lfeon;
        rc->lfe_out = (s->output & A52_LFE) ? 1 : 0;
        rc->fscod = (int8_t)s->fscod;
        rc->halfrate = (int8_t)s->halfrate;
        memcpy(rc->deltba, s->eff_deltba, sizeof(rc->deltba));
        br.skip(mantissa_bits(s, nfchans));
        return 0;
    }

    QuantSet qs;
    qs.q1_ptr = qs.q2_ptr = qs.q4_ptr = -1;
    int done_cpl = 0;
    for (int i = 0; i < nfchans; i++) {
        coeff_get(s, br, sink, blk, i, s->fbw_exp[i], s->fbw_bap[i],
                  coeff[i], dithflag[i], s->endmant[i], qs);
        if ((s->chincpl >> i) & 1 && !done_cpl) {
            done_cpl = 1;
            coeff_get_coupling(s, br, sink, blk, nfchans, coeff, dithflag,
                               qs);
        }
    }

    // rematrix band mask
    if (s->acmod == 2) {
        int end = s->endmant[0] < s->endmant[1] ? s->endmant[0] : s->endmant[1];
        int j = 13;
        for (int bi = 0; bi < 4; bi++) {
            int band = REMATRIX_BAND[bi];
            if (s->rematflg & (1u << bi)) {
                int hi = band < end ? band : end;
                for (int k = j; k < hi; k++) out->remat[blk][k] = 1;
            }
            j = band;
            if (j >= end) break;
        }
    }

    if (s->lfeon) {
        uint8_t e[256] = {0};
        int8_t bp[256] = {0};
        memcpy(e, s->lfe_exp, 7);
        memcpy(bp, s->lfe_bap, 7);
        if (s->output & A52_LFE)
            coeff_get(s, br, sink, blk, 5, e, bp, s->dynrng, 0, 7, qs);
        else {
            DropSink drop;
            coeff_get(s, br, drop, blk, 5, e, bp, 0.0f, 0, 7, qs);
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// frame-level entry points
// ---------------------------------------------------------------------------

extern "C" int ac3h_syncinfo(const uint8_t* buf, int* flags,
                             int* sample_rate, int* bit_rate)
{
    static const uint8_t lfeon_bit[8] = {0x10, 0x10, 0x04, 0x04,
                                         0x04, 0x01, 0x04, 0x01};
    if (buf[0] != 0x0B || buf[1] != 0x77) return 0;
    if (buf[5] >= 0x60) return 0;
    int half = HALFRATE_TBL[buf[5] >> 3];
    int acmod = buf[6] >> 5;
    *flags = (((buf[6] & 0xF8) == 0x50) ? A52_DOLBY : acmod)
             | ((buf[6] & lfeon_bit[acmod]) ? A52_LFE : 0);
    int frmsizecod = buf[4] & 63;
    if (frmsizecod >= 38) return 0;
    int bitrate = RATE_TBL[frmsizecod >> 1];
    *bit_rate = (bitrate * 1000) >> half;
    switch (buf[4] & 0xC0) {
    case 0x00: *sample_rate = 48000 >> half; return 4 * bitrate;
    case 0x40: *sample_rate = 44100 >> half;
               return 2 * (320 * bitrate / 147 + (frmsizecod & 1));
    case 0x80: *sample_rate = 32000 >> half; return 6 * bitrate;
    }
    return 0;
}

template <class SINK>
static int ac3h_frame_t(Parser* s, const uint8_t* buf, int flags,
                        float level, float bias, FrameOut* out, SINK& sink)
{
    static const double CLEV[4] = {LEVEL_3DB_D, LEVEL_45DB_D, 0.5, LEVEL_45DB_D};
    static const double SLEV[4] = {LEVEL_3DB_D, 0.5, 0.0, 0.5};

    memset(out->remat, 0, sizeof(out->remat));
    memset(out->blksw, 0, sizeof(out->blksw));
    memset(out->coeff, 0, sizeof(out->coeff));

    s->fscod = buf[4] >> 6;
    s->halfrate = HALFRATE_TBL[buf[5] >> 3];
    s->acmod = buf[6] >> 5;
    int acmod = s->acmod;
    // clamp bit reads to the frame (size from the header; callers always
    // syncinfo-gate, so a valid header is present)
    int fl_, sr_, brate_;
    int fsize = ac3h_syncinfo(buf, &fl_, &sr_, &brate_);
    BitReader br{buf, 6 * 8, fsize > 0 ? fsize : 7};
    br.skip(3);
    if (acmod == 2 && br.read(2) == 2) acmod = A52_DOLBY;
    s->clev = 0;
    s->slev = 0;
    if ((acmod & 1) && acmod != 1) s->clev = (float)CLEV[br.read(2)];
    if (acmod & 4) s->slev = (float)SLEV[br.read(2)];
    s->lfeon = br.read(1);

    float lvl = level;
    int outmode = downmix_init(acmod, flags, &lvl, s->clev, s->slev);
    if (outmode < 0) return 1;
    s->output = outmode;
    if (s->lfeon && (flags & A52_LFE)) s->output |= A52_LFE;
    s->level = (float)((double)lvl * 2.0);
    s->dynrng = s->level;
    s->bias = bias;
    s->cplba.deltbae = DELTA_BIT_NONE;
    for (int i = 0; i < 5; i++) s->ba[i].deltbae = DELTA_BIT_NONE;

    for (int ci = 0; ci <= (acmod == 0 ? 1 : 0); ci++) {
        br.skip(5);
        if (br.read(1)) br.skip(8);
        if (br.read(1)) br.skip(8);
        if (br.read(1)) br.skip(7);
    }
    br.skip(2);
    if (br.read(1)) br.skip(14);
    if (br.read(1)) br.skip(14);
    if (br.read(1)) {
        int addbsil = br.read(6);
        br.skip(8 * (addbsil + 1));
    }

    out->acmod = s->acmod;
    out->lfeon = s->lfeon;
    out->output = s->output;
    out->nfchans = NFCHANS_TBL[s->acmod];
    out->slev = s->slev;
    out->bias = bias;

    for (int blk = 0; blk < 6; blk++)
        if (parse_block(s, br, out, blk, sink))
            return 2 + blk;
    return 0;
}

extern "C" int ac3h_frame(Parser* s, const uint8_t* buf, int flags,
                          float level, float bias, FrameOut* out)
{
    memset(out->q, 0, sizeof(out->q));
    memset(out->a, 0, sizeof(out->a));
    memset(out->b, 0, sizeof(out->b));
    QabSink sink{out};
    return ac3h_frame_t(s, buf, flags, level, bias, out, sink);
}

// parse a run of consecutive frames (one stream) into an array of FrameOut
extern "C" int ac3h_frames(Parser* s, const uint8_t* buf, int64_t buflen,
                           int nframes, int flags, float level, float bias,
                           FrameOut* outs, int32_t* frame_sizes)
{
    int64_t pos = 0;
    int done = 0;
    int fl, sr, brr;
    while (done < nframes && pos + 7 <= buflen) {
        int size = ac3h_syncinfo(buf + pos, &fl, &sr, &brr);
        if (size == 0) { pos++; continue; }
        if (pos + size > buflen) break;
        int r = ac3h_frame(s, buf + pos, flags, level, bias, &outs[done]);
        if (r == 0) {
            frame_sizes[done] = size;
            done++;
        }
        pos += size;
    }
    return done;
}

// ===========================================================================
// Native CPU decode backend: bit-exact IMDCT filterbank + downmix.
//
// Compiled with -ffp-contract=off so every f32 multiply rounds exactly as
// the reference build does.  The filterbank and mixers are data-driven --
// a plan of butterfly ops and index tables executed by the generic
// interpreters in ac3fb.inc (shared with the fixed/double sample-type
// builds in ac3sample.inc).  The *operation tree* preserves the reference
// decoder's evaluation order (imdct.c:77-345, downmix.c:332-685), which is
// what bit-exactness requires; the code structure is the planner +
// interpreter design also used by ops/imdct_exact.py on the device side.
// ===========================================================================

#include "ac3fb.inc"

struct FloatOps {
    typedef float sample_t;
    typedef float level_t;
    static float MUL(float a, float b) { return a * b; }
    static float BIASV(float x, float b) { return x + b; }
};

static FbTables<float> g_fbt;
static uint8_t g_fftorder[128];

static double bessel_i0(double x) {
    double b = 1.0;
    for (int i = 100; i; i--) b = b * x / ((double)i * i) + 1.0;
    return b;
}

static void build_fftorder() {
    // split-radix DIT ordering (see tables.py _fftorder)
    struct R {
        static void order(int n, int stride, int base, int* out, int& k) {
            if (n == 1) { out[k++] = base & 255; return; }
            if (n == 2) { out[k++] = base & 255; out[k++] = (base + stride) & 255; return; }
            order(n / 2, stride * 2, base, out, k);
            order(n / 4, stride * 4, base + stride, out, k);
            order(n / 4, stride * 4, base - stride, out, k);
        }
    };
    int tmp[256];
    int k = 0;
    R::order(256, 1, 0, tmp, k);
    for (int i = 0; i < 128; i++) g_fftorder[i] = (uint8_t)(tmp[i] & 255);
}

// fill an FbTables<S> from the closed-form twiddle/window formulas
// (KBD window per imdct.c:358-412; the CAST hook converts per sample type)
template <class S, class CAST>
static void fb_fill_tables(FbTables<S>& t, const uint8_t* order, CAST cast) {
    double sum = 0, local[256];
    const double c = 5.0 * M_PI / 256.0;
    for (int i = 0; i < 256; i++) {
        sum += bessel_i0((double)i * (256 - i) * c * c);
        local[i] = sum;
    }
    sum += 1.0;
    for (int i = 0; i < 256; i++) t.window[i] = cast(sqrt(local[i] / sum));
    for (int i = 0; i < 3; i++) t.roots16[i] = cast(cos((M_PI / 8) * (i + 1)));
    for (int i = 0; i < 7; i++) t.roots32[i] = cast(cos((M_PI / 16) * (i + 1)));
    for (int i = 0; i < 15; i++) t.roots64[i] = cast(cos((M_PI / 32) * (i + 1)));
    for (int i = 0; i < 31; i++) t.roots128[i] = cast(cos((M_PI / 64) * (i + 1)));
    for (int i = 0; i < 128; i++) {
        int k = order[i] / 2 + 64;
        double s = i < 64 ? 1.0 : -1.0;
        t.pre1[i].re = cast(s * cos((M_PI / 256) * (k - 0.25)));
        t.pre1[i].im = cast(s * sin((M_PI / 256) * (k - 0.25)));
    }
    for (int i = 0; i < 64; i++) {
        t.post1[i].re = cast(cos((M_PI / 256) * (i + 0.5)));
        t.post1[i].im = cast(sin((M_PI / 256) * (i + 0.5)));
    }
    for (int i = 0; i < 64; i++) {
        int k = order[i] / 4;
        t.pre2[i].re = cast(cos((M_PI / 128) * (k - 0.25)));
        t.pre2[i].im = cast(sin((M_PI / 128) * (k - 0.25)));
    }
    for (int i = 0; i < 32; i++) {
        t.post2[i].re = cast(cos((M_PI / 128) * (i + 0.5)));
        t.post2[i].im = cast(sin((M_PI / 128) * (i + 0.5)));
    }
}

static void imdct_init_native() {
    // once per process: ac3h_parse_many calls this from every worker
    // thread, and two threads building the shared plans at once corrupt
    // the heap (fb_plans appends to static std::vectors)
    static std::once_flag once;
    std::call_once(once, [] {
        build_fftorder();
        fb_fill_tables(g_fbt, g_fftorder, [](double x) { return (float)x; });
        fb_plans(g_fftorder);        // build the shared butterfly schedule
    });
}

// data [256] in place -> windowed overlap-added output; delay [128] OLA state
extern "C" void ac3h_imdct512(float* data, float* delay, float bias) {
    imdct_init_native();
    fb_synth<FloatOps>(fb_plans(g_fftorder), false, g_fbt, data, delay, bias);
}

extern "C" void ac3h_imdct256(float* data, float* delay, float bias) {
    imdct_init_native();
    fb_synth<FloatOps>(fb_plans(g_fftorder), true, g_fbt, data, delay, bias);
}

// ---------------------------------------------------------------------------
// full native block pipeline: dequant -> rematrix -> paths -> mix -> planes
// (port of models/decoder.py _block_step; exact mixer orders of downmix.c)
// ---------------------------------------------------------------------------

struct NativeDecoder {
    Parser* p;
    float delay[6][128];
    int downmixed;
};

extern "C" NativeDecoder* ac3h_dec_new() {
    NativeDecoder* d = new NativeDecoder();
    memset(d->delay, 0, sizeof(d->delay));
    d->downmixed = 1;
    d->p = ac3h_new();
    return d;
}
extern "C" void ac3h_dec_free(NativeDecoder* d) { ac3h_free(d->p); delete d; }
extern "C" void ac3h_dec_set_drc(NativeDecoder* d, int e) { d->p->dynrnge = e; }
extern "C" void ac3h_dec_set_dynrng_call(NativeDecoder* d, dynrng_cb cb,
                                         void* data) {
    ac3h_set_dynrng_call(d->p, cb, data);
}

static void native_downmix(float s[6][256], int n, int acmod, int output,
                           float bias, float slev);
static void native_upmix(float s[6][128], int acmod, int output);
static void native_downmix_delay(float s[6][128], int acmod, int output,
                                 float slev);

// decode one parsed frame (FrameOut) into PCM planes [6][6][256]
extern "C" int ac3h_dec_blocks(NativeDecoder* d, const FrameOut* fo,
                               float* pcm /* [6][nch_out][256] */,
                               int* nch_out)
{
    imdct_init_native();
    Parser* s = d->p;
    int nf = fo->nfchans;
    int output = fo->output;
    int nf_out = NFCHANS_TBL[output & A52_CHANNEL_MASK];
    int lfe_out = (output & A52_LFE) ? 1 : 0;
    *nch_out = nf_out + lfe_out;
    float bias = fo->bias;
    float slev = fo->slev;

    for (int blk = 0; blk < 6; blk++) {
        float freq[6][256];
        for (int ch = 0; ch < 6; ch++)
            for (int i = 0; i < 256; i++)
                freq[ch][i] = (fo->q[blk][ch][i] * fo->a[blk][ch][i])
                              * fo->b[blk][ch][i];
        if (fo->acmod == A52_STEREO) {
            for (int i = 0; i < 256; i++)
                if (fo->remat[blk][i]) {
                    float t0 = freq[0][i], t1 = freq[1][i];
                    freq[0][i] = t0 + t1;
                    freq[1][i] = t0 - t1;
                }
        }
        float* out = pcm + (size_t)blk * (*nch_out) * 256;
        int slot = 0;
        if (lfe_out) {
            // LFE: always 512-pt, state bias
            float tmp[256];
            memcpy(tmp, freq[5], sizeof(tmp));
            ac3h_imdct512(tmp, d->delay[5], bias);
            memcpy(out, tmp, sizeof(tmp));
            slot = 1;
        }
        // path decision (parse.c:881-886)
        bool uniform = true;
        for (int i = 1; i < nf; i++)
            if (fo->blksw[blk][i] != fo->blksw[blk][0]) uniform = false;
        bool freq_path = (nf_out < nf) && uniform;

        if (freq_path) {
            native_downmix(freq, 256, fo->acmod, output, 0.0f, slev);
            if (!d->downmixed) {
                native_downmix_delay(d->delay, fo->acmod, output, slev);
                d->downmixed = 1;
            }
            for (int ch = 0; ch < nf_out; ch++) {
                if (fo->blksw[blk][0])
                    ac3h_imdct256(freq[ch], d->delay[ch], bias);
                else
                    ac3h_imdct512(freq[ch], d->delay[ch], bias);
                memcpy(out + (size_t)(slot + ch) * 256, freq[ch], 1024);
            }
        } else {
            if (d->downmixed) {
                native_upmix(d->delay, fo->acmod, output);
                d->downmixed = 0;
            }
            for (int ch = 0; ch < nf; ch++) {
                float chb = (fo->chanbias >> ch) & 1 ? 0.0f : bias;
                if (fo->coeff[blk][ch] == 0.0f) {
                    for (int i = 0; i < 256; i++) freq[ch][i] = chb;
                    // delay kept (reference skips the imdct entirely)
                } else if (fo->blksw[blk][ch]) {
                    ac3h_imdct256(freq[ch], d->delay[ch], chb);
                } else {
                    ac3h_imdct512(freq[ch], d->delay[ch], chb);
                }
            }
            native_downmix(freq, 256, fo->acmod, output, bias, slev);
            for (int ch = 0; ch < nf_out; ch++)
                memcpy(out + (size_t)(slot + ch) * 256, freq[ch], 1024);
            d->downmixed = 0;
        }
        if (freq_path) d->downmixed = 1;
    }
    return 0;
}

// full native decode: parse + pipeline (the CPU fallback / bit-exact path)
extern "C" int ac3h_dec_frame(NativeDecoder* d, const uint8_t* buf, int flags,
                              float level, float bias, float* pcm,
                              int* nch_out)
{
    static thread_local FrameOut fo;
    int r = ac3h_frame(d->p, buf, flags, level, bias, &fo);
    if (r) return r;
    return ac3h_dec_blocks(d, &fo, pcm, nch_out);
}

// mixer byte-code dispatch (programs + interpreter in ac3fb.inc; rounding
// per downmix.c:332-619 / a52_upmix:621-685)
static void native_downmix(float s[6][256], int n, int acmod, int output,
                           float bias, float slev)
{
    float* planes[6];
    for (int c = 0; c < 6; c++) planes[c] = s[c];
    mix_run<FloatOps>(mix_program(acmod, output, slev == 0.0f), planes, n,
                      bias);
}

static void native_downmix_delay(float dl[6][128], int acmod, int output,
                                 float slev)
{
    // same mixer programs over the 128-sample OLA region, bias 0
    // (parse.c:925-926)
    float* planes[6];
    for (int c = 0; c < 6; c++) planes[c] = dl[c];
    mix_run<FloatOps>(mix_program(acmod, output, slev == 0.0f), planes, 128,
                      0.0f);
}

static void native_upmix(float dl[6][128], int acmod, int output)
{
    float* planes[6];
    for (int c = 0; c < 6; c++) planes[c] = dl[c];
    mix_run<FloatOps>(upmix_program(acmod, output), planes, 128, 0.0f);
}

extern "C" void ac3h_dec_get_delay(NativeDecoder* d, float* out, int* dmx) {
    memcpy(out, d->delay, sizeof(d->delay));
    *dmx = d->downmixed;
}

// ===========================================================================
// Dense multi-lane parse: the host half of the end-to-end TPU pipeline.
//
// One call per batch: N independent stream parsers consume their byte
// buffers and emit device-ready tensors -- dequantized frequency planes
// ((q*a)*b in the same IEEE f32 order the Python host pass uses), side
// flags, and (when the frame qualifies for the steady frequency-domain
// path) host-premixed output planes computed with the shared mixer
// byte-code, so the device sees only nf_out(+LFE) planes.  Lanes fan out
// over std::threads; the Python caller releases the GIL for the whole
// batch (ctypes).
// ===========================================================================

#include <atomic>
#include <thread>

// block-float scale groups per premixed plane (32 bins each); must match
// ac3acm_tpu/host/native.py PRE_GROUPS and pipeline._expand_compact
static const int PRE_GROUPS = 16;

// rows are blocks: row = frame * 6 + blk
struct DenseStride {
    int64_t full;      // floats per lane in freq_full
    int64_t pre;       // floats per lane in freq_pre
    int64_t rows;      // maxframes * 6
};

extern "C" int ac3h_parse_dense(
    Parser* s, const uint8_t* buf, int64_t buflen, int maxframes,
    int flags, float level, float bias, int pre_planes,
    float* freq_full,        // [maxframes*6, 6, 256]
    float* freq_pre,         // [maxframes*6, pre_planes, 256] or null
    int16_t* pre_man,        // [maxframes*6, pre_planes, 256] or null:
                             //   block-float mantissas of freq_pre (compact
                             //   H2D: 2 B/coef instead of 4)
    float* pre_scale,        // [maxframes*6, pre_planes, PRE_GROUPS] or
                             //   null: per-16-bin-group scale;
                             //   freq = man * scale
    uint8_t* blksw,          // [maxframes*6, 5]
    float* coeff,            // [maxframes*6, 5]
    uint8_t* remat,          // [maxframes*6, 256]
    float* biasv,            // [maxframes*6]
    uint8_t* valid,          // [maxframes]
    uint8_t* premix_ok,      // [maxframes]
    int32_t* meta,           // [maxframes, 8]: per-frame acmod lfeon output
                             //   nfchans chanbias slev_zero have_meta resv
                             //   (per-frame so a mid-stream format change
                             //   inside one call keeps correct downmix meta
                             //   for every frame, like the python parser)
    int64_t* consumed)
{
    static thread_local FrameOut fo;
    imdct_init_native();
    int64_t pos = 0;
    int done = 0;
    int fl, sr, brr;
    while (done < maxframes && pos + 7 <= buflen) {
        int size = ac3h_syncinfo(buf + pos, &fl, &sr, &brr);
        if (size == 0) { pos++; continue; }
        if (pos + size > buflen) break;
        int64_t row0 = (int64_t)done * 6;
        float* ff0 = freq_full + row0 * 6 * 256;
        memset(ff0, 0, 6 * 6 * 256 * 4);
        FreqSink sink{ff0};          // dequant in place, no (q,a,b) staging
        int r = ac3h_frame_t(s, buf + pos, flags, level, bias, &fo, sink);
        pos += size;
        if (r != 0) {
            // malformed side-info: masked lane-frame, zeroed tensors
            // (a52dec.c:302-306 resync semantics over a batch)
            memset(ff0, 0, 6 * 6 * 256 * 4);
            if (freq_pre)
                memset(freq_pre + row0 * pre_planes * 256, 0,
                       (size_t)(6 * pre_planes * 256) * 4);
            if (pre_man) {
                memset(pre_man + row0 * pre_planes * 256, 0,
                       (size_t)(6 * pre_planes * 256) * 2);
                memset(pre_scale + row0 * pre_planes * PRE_GROUPS, 0,
                       (size_t)(6 * pre_planes * PRE_GROUPS) * 4);
            }
            memset(blksw + row0 * 5, 0, 30);
            memset(coeff + row0 * 5, 0, 120);
            memset(remat + row0 * 256, 0, 6 * 256);
            for (int b = 0; b < 6; b++) biasv[row0 + b] = bias;
            valid[done] = 0;
            premix_ok[done] = 1;     // zeros are valid in either layout
            meta[(int64_t)done * 8 + 6] = 0;
            done++;
            continue;
        }
        int nf = fo.nfchans;
        int nf_out = NFCHANS_TBL[fo.output & A52_CHANNEL_MASK];
        int lfe = (fo.output & A52_LFE) ? 1 : 0;
        bool slev_zero = fo.slev == 0.0f;
        bool reduces = nf_out < nf;
        const uint8_t* prog = mix_program(fo.acmod, fo.output, slev_zero);
        // passthrough premix: identity time-domain mix (MP_NONE program,
        // e.g. stereo->stereo) with no bias-in-mix channel -- the premix is
        // then rematrix-only and ships nf (+LFE) planes instead of 6
        bool ident = !reduces && nf_out == nf && *prog == MXEND
                     && fo.chanbias == 0;
        bool pre_eligible = (reduces || ident) && freq_pre
                            && pre_planes == nf_out + lfe;
        for (int b = 0; b < 6; b++) {
            int64_t row = row0 + b;
            memcpy(blksw + row * 5, fo.blksw[b], 5);
            memcpy(coeff + row * 5, fo.coeff[b], 20);
            memcpy(remat + row * 256, fo.remat[b], 256);
            biasv[row] = fo.bias;
            if (reduces) {
                // steady freq-path validity: uniform blksw across channels
                for (int ch = 1; ch < nf; ch++)
                    if (fo.blksw[b][ch] != fo.blksw[b][0])
                        pre_eligible = false;
            } else if (ident) {
                // steady time-path validity: no skipped (zero-coeff)
                // channel, whose delay-keep is a real recurrence
                for (int ch = 0; ch < nf; ch++)
                    if (fo.coeff[b][ch] == 0.0f) pre_eligible = false;
            }
        }
        if (pre_eligible) {
            for (int b = 0; b < 6; b++) {
                int64_t row = row0 + b;
                const float* ff = freq_full + row * 6 * 256;
                float* fp = freq_pre + row * pre_planes * 256;
                // mix in place over the output planes; planes >= nf_out are
                // read-only views of the full tensor (the mixer programs
                // only write planes < nf_out; stereo rematrix additionally
                // writes plane 1, which needs scratch when not kept)
                float scratch[256];
                float* planes[6];
                for (int ch = 0; ch < 5; ch++)
                    planes[ch] = ch < nf_out ? fp + ch * 256
                                             : (float*)(ff + ch * 256);
                if (fo.acmod == A52_STEREO && nf_out < 2)
                    planes[1] = scratch;
                for (int ch = 0; ch < nf_out; ch++)
                    memcpy(planes[ch], ff + ch * 256, 1024);
                if (fo.acmod == A52_STEREO) {
                    if (nf_out < 2) memcpy(scratch, ff + 256, 1024);
                    const uint8_t* m = fo.remat[b];
                    for (int i = 0; i < 256; i++)
                        if (m[i]) {
                            float t0 = planes[0][i], t1 = planes[1][i];
                            planes[0][i] = t0 + t1;
                            planes[1][i] = t0 - t1;
                        }
                }
                mix_run<FloatOps>(prog, planes, 256, 0.0f);
                if (lfe)                         // LFE plane comes last
                    memcpy(fp + nf_out * 256, ff + 5 * 256, 1024);
                if (pre_man) {
                    // block-float: one shared exponent per 16-bin group
                    // (spectra decay steeply, so a per-plane exponent
                    // would quantize the high bins against the plane max
                    // and drift the PCM by several LSB); with per-group
                    // scales the device reconstruction stays within
                    // 1 int16 LSB of the f32 planes (gated in
                    // tests/test_native_decoder.py::test_compact_h2d)
                    int16_t* mp = pre_man + row * pre_planes * 256;
                    float* sp = pre_scale + row * pre_planes * PRE_GROUPS;
                    for (int p = 0; p < pre_planes; p++) {
                        for (int g = 0; g < PRE_GROUPS; g++) {
                            const int gw = 256 / PRE_GROUPS;
                            const float* v = fp + p * 256 + g * gw;
                            int16_t* m16 = mp + p * 256 + g * gw;
                            float amax = 0.f;
                            for (int i = 0; i < gw; i++) {
                                float a = fabsf(v[i]);
                                if (a > amax) amax = a;
                            }
                            if (amax == 0.f) {
                                memset(m16, 0, gw * 2);
                                sp[p * PRE_GROUPS + g] = 0.f;
                                continue;
                            }
                            int e;
                            frexpf(amax, &e);      // amax = m*2^e, m<1
                            float sc = ldexpf(1.f, 15 - e);
                            for (int i = 0; i < gw; i++) {
                                long q = lrintf(v[i] * sc);
                                if (q > 32767) q = 32767;
                                if (q < -32768) q = -32768;
                                m16[i] = (int16_t)q;
                            }
                            sp[p * PRE_GROUPS + g] = ldexpf(1.f, e - 15);
                        }
                    }
                }
            }
        }
        valid[done] = 1;
        premix_ok[done] = pre_eligible ? 1 : 0;
        int32_t* m = meta + (int64_t)done * 8;
        m[0] = fo.acmod;
        m[1] = fo.lfeon;
        m[2] = fo.output;
        m[3] = fo.nfchans;
        m[4] = fo.chanbias;
        m[5] = slev_zero ? 1 : 0;
        m[6] = 1;
        done++;
    }
    *consumed = pos;
    return done;
}

extern "C" void ac3h_parse_many(
    void* const* parsers, int nlanes,
    const uint8_t* const* bufs, const int64_t* lens, int maxframes,
    int flags, float level, float bias, int pre_planes,
    float* freq_full, float* freq_pre, int16_t* pre_man, float* pre_scale,
    uint8_t* blksw, float* coeff,
    uint8_t* remat, float* biasv, uint8_t* valid, uint8_t* premix_ok,
    int32_t* meta, int64_t* consumed, int32_t* nframes, int nthreads)
{
    const int64_t rows = (int64_t)maxframes * 6;
    auto work = [&](int l) {
        nframes[l] = ac3h_parse_dense(
            (Parser*)parsers[l], bufs[l], lens[l], maxframes, flags, level,
            bias, pre_planes,
            freq_full + (int64_t)l * rows * 6 * 256,
            freq_pre ? freq_pre + (int64_t)l * rows * pre_planes * 256
                     : nullptr,
            pre_man ? pre_man + (int64_t)l * rows * pre_planes * 256
                    : nullptr,
            pre_scale ? pre_scale
                        + (int64_t)l * rows * pre_planes * PRE_GROUPS
                      : nullptr,
            blksw + (int64_t)l * rows * 5,
            coeff + (int64_t)l * rows * 5,
            remat + (int64_t)l * rows * 256,
            biasv + (int64_t)l * rows,
            valid + (int64_t)l * maxframes,
            premix_ok + (int64_t)l * maxframes,
            meta + (int64_t)l * maxframes * 8,
            consumed + l);
    };
    if (nthreads <= 1 || nlanes <= 1) {
        for (int l = 0; l < nlanes; l++) work(l);
        return;
    }
    std::atomic<int> next{0};
    int nt = nthreads < nlanes ? nthreads : nlanes;
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; t++)
        pool.emplace_back([&]() {
            for (;;) {
                int l = next.fetch_add(1);
                if (l >= nlanes) return;
                work(l);
            }
        });
    for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// Raw-H2D side-info parse: frame bytes + per-block RawRecWire records out,
// mantissa walk skipped (the device unpacks mantissas from the bytes).
// The production host half of BatchedDecoder(parser="raw").
// ---------------------------------------------------------------------------

extern "C" int ac3h_parse_sideinfo(
    Parser* s, const uint8_t* buf, int64_t buflen, int maxframes,
    int flags, float level, float bias,
    uint8_t* frames_out, int mb,     // [maxframes, mb] frame byte copies
    int32_t* fsizes,                 // [maxframes] actual frame sizes
    RawRecWire* recs,                // [maxframes * 6]
    uint8_t* valid,                  // [maxframes]
    int32_t* fmtinfo,                // [maxframes, 4]: acmod output slev0 have
    int64_t* consumed)
{
    static thread_local FrameOut fo;
    int64_t pos = 0;
    int done = 0;
    int fl, sr, brr;
    while (done < maxframes && pos + 7 <= buflen) {
        int size = ac3h_syncinfo(buf + pos, &fl, &sr, &brr);
        if (size == 0) { pos++; continue; }
        if (pos + size > buflen) break;
        RawRecWire* rb = recs + (int64_t)done * 6;
        uint8_t* frow = frames_out + (int64_t)done * mb;
        int32_t* fi = fmtinfo + (int64_t)done * 4;
        fsizes[done] = size;
        if (size > mb) {
            // frame larger than the staging row (mid-stream bitrate jump
            // past the caller's bound): masked lane-frame
            for (int b = 0; b < 6; b++) raw_rec_null(rb + b);
            memset(frow, 0, mb);
            valid[done] = 0;
            fi[0] = fi[1] = fi[2] = fi[3] = 0;
            pos += size;
            done++;
            continue;
        }
        memcpy(frow, buf + pos, size);
        memset(frow + size, 0, mb - size);
        s->rec_base = rb;
        DropSink sink;
        int r = ac3h_frame_t(s, buf + pos, flags, level, bias, &fo, sink);
        s->rec_base = nullptr;
        pos += size;
        if (r != 0) {
            for (int b = 0; b < 6; b++) raw_rec_null(rb + b);
            memset(frow, 0, mb);
            valid[done] = 0;
            fi[0] = fi[1] = fi[2] = fi[3] = 0;
        } else {
            valid[done] = 1;
            fi[0] = fo.acmod;
            fi[1] = fo.output;
            fi[2] = fo.slev == 0.0f ? 1 : 0;
            fi[3] = 1;
        }
        done++;
    }
    *consumed = pos;
    return done;
}

extern "C" void ac3h_parse_sideinfo_many(
    void* const* parsers, int nlanes,
    const uint8_t* const* bufs, const int64_t* lens, int maxframes,
    int flags, float level, float bias,
    uint8_t* frames_out, int mb, int32_t* fsizes, RawRecWire* recs,
    uint8_t* valid, int32_t* fmtinfo, int64_t* consumed, int32_t* nframes,
    int nthreads)
{
    auto work = [&](int l) {
        nframes[l] = ac3h_parse_sideinfo(
            (Parser*)parsers[l], bufs[l], lens[l], maxframes, flags, level,
            bias,
            frames_out + (int64_t)l * maxframes * mb, mb,
            fsizes + (int64_t)l * maxframes,
            recs + (int64_t)l * maxframes * 6,
            valid + (int64_t)l * maxframes,
            fmtinfo + (int64_t)l * maxframes * 4,
            consumed + l);
    };
    if (nthreads <= 1 || nlanes <= 1) {
        for (int l = 0; l < nlanes; l++) work(l);
        return;
    }
    std::atomic<int> next{0};
    int nt = nthreads < nlanes ? nthreads : nlanes;
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; t++)
        pool.emplace_back([&]() {
            for (;;) {
                int l = next.fetch_add(1);
                if (l >= nlanes) return;
                work(l);
            }
        });
    for (auto& th : pool) th.join();
}

extern "C" int ac3h_rawrec_size() { return (int)sizeof(RawRecWire); }

// ===========================================================================
// Native frame packer: the host half of the encode path.
//
// Consumes the device encoder's dense outputs (bap, raw quantized
// mantissas, encoded exponents, strategies, SNR offsets) and assembles
// serial AC-3 frames -- header, grouped-mantissa combining in coefficient
// order, zero fill, dual CRC with the polynomial-inverse back-patch.
// Behavioural parity with the project's Python packer (host/pack.py),
// cross-checked byte-for-byte in tests; frames fan out over std::threads.
// ===========================================================================

static const uint32_t CRC16_POLY = (1u << 0) | (1u << 2) | (1u << 15)
                                   | (1u << 16);

struct PackBits {
    std::vector<uint8_t> buf;
    uint64_t acc = 0;
    int nbits = 0;
    inline void put(int n, uint32_t v) {
        acc = (acc << n) | (v & ((n >= 32) ? 0xFFFFFFFFu
                                           : ((1u << n) - 1)));
        nbits += n;
        while (nbits >= 8) {
            nbits -= 8;
            buf.push_back((uint8_t)(acc >> nbits));
        }
    }
    void flushz() {
        if (nbits) {
            buf.push_back((uint8_t)(acc << (8 - nbits)));
            nbits = 0;
        }
    }
};

static uint16_t g_crc_tab[256];
static bool g_crc_ready = false;
static void crc_init() {
    if (g_crc_ready) return;
    for (int n = 0; n < 256; n++) {
        uint32_t c = n << 8;
        for (int k = 0; k < 8; k++)
            c = (c & (1u << 15)) ? (((c << 1) & 0xFFFF) ^ (CRC16_POLY & 0xFFFF))
                                 : (c << 1);
        g_crc_tab[n] = (uint16_t)(c & 0xFFFF);
    }
    g_crc_ready = true;
}

static inline uint16_t ac3_crc(const uint8_t* p, size_t n, uint16_t crc) {
    for (size_t i = 0; i < n; i++)
        crc = (uint16_t)(g_crc_tab[p[i] ^ (crc >> 8)] ^ ((crc << 8) & 0xFFFF));
    return crc;
}

static uint32_t mul_poly(uint32_t a, uint32_t b, uint32_t poly) {
    uint32_t c = 0;
    while (a) {
        if (a & 1) c ^= b;
        a >>= 1;
        b <<= 1;
        if (b & (1u << 16)) b ^= poly;
    }
    return c;
}

static uint32_t pow_poly(uint32_t a, uint32_t n, uint32_t poly) {
    uint32_t r = 1;
    while (n) {
        if (n & 1) r = mul_poly(r, a, poly);
        a = mul_poly(a, a, poly);
        n >>= 1;
    }
    return r;
}

struct PackCfg {
    int fscod, frmsizecod, halfratecod, acmod, lfe, nch, nf, frame_size;
    int nb[6];
    uint32_t crc_inv;      // pow_poly(POLY>>1, 16*fs58-16) for this size
};

static void pack_one(const PackCfg& C, const int8_t* bap,
                     const int32_t* qmant, const uint8_t* enc_exp,
                     const int32_t* strat, int csnr, int fsnr, uint8_t* out)
{
    // layout strides: bap/qmant/enc_exp [6][nch][256], strat [6][nch]
    const int nch = C.nch, nf = C.nf;
    const int lfe_ch = C.lfe ? nf : -1;
    PackBits bw;
    bw.buf.reserve(C.frame_size * 2 + 8);
    bw.put(16, 0x0B77);
    bw.put(16, 0);                        // crc1 patched later
    bw.put(2, C.fscod);
    bw.put(6, C.frmsizecod);
    bw.put(5, 8 + C.halfratecod);         // bsid
    bw.put(3, 0);                         // bsmod
    bw.put(3, C.acmod);
    if ((C.acmod & 1) && C.acmod != 1) bw.put(2, 1);   // cmixlev -4.5 dB
    if (C.acmod & 4) bw.put(2, 1);                     // surmixlev -6 dB
    if (C.acmod == 2) bw.put(2, 0);                    // dsurmod
    bw.put(1, C.lfe ? 1 : 0);
    bw.put(5, 31);                        // dialnorm -31 dB
    bw.put(1, 0); bw.put(1, 0); bw.put(1, 0); bw.put(1, 0);
    bw.put(1, 1);                         // origbs
    bw.put(1, 0); bw.put(1, 0); bw.put(1, 0);

    int32_t qm[6 * 256];
    for (int blk = 0; blk < 6; blk++) {
        const int8_t* bapb = bap + (size_t)blk * nch * 256;
        const uint8_t* expb = enc_exp + (size_t)blk * nch * 256;
        const int32_t* strb = strat + (size_t)blk * nch;
        for (int c = 0; c < nf; c++) bw.put(1, 0);     // blksw: 512-pt
        for (int c = 0; c < nf; c++) bw.put(1, 1);     // dithflag
        bw.put(1, 0);                                  // dynrnge
        if (blk == 0) { bw.put(1, 1); bw.put(1, 0); }  // cplstre, cplinu
        else bw.put(1, 0);
        if (C.acmod == 2) {
            if (blk == 0) { bw.put(1, 1); for (int k = 0; k < 4; k++) bw.put(1, 0); }
            else bw.put(1, 0);
        }
        for (int c = 0; c < nf; c++) bw.put(2, strb[c]);
        if (C.lfe) bw.put(1, strb[lfe_ch]);
        for (int c = 0; c < nf; c++)
            if (strb[c] != EXP_REUSE) bw.put(6, 50);   // chbwcod
        for (int c = 0; c < nch; c++) {
            if (strb[c] == EXP_REUSE) continue;
            int gsize = (c == lfe_ch) ? 1
                        : (strb[c] == 1 ? 1 : strb[c] == 2 ? 2 : 4);
            int nbc = C.nb[c];
            int ngroups = (nbc + gsize * 3 - 4) / (3 * gsize);
            const uint8_t* e = expb + (size_t)c * 256;
            bw.put(4, e[0]);
            int prev = e[0], p = 1;
            for (int g = 0; g < ngroups; g++) {
                int d0, d1, d2;
                d0 = e[p] - prev + 2; prev = e[p]; p += gsize;
                d1 = e[p] - prev + 2; prev = e[p]; p += gsize;
                d2 = e[p] - prev + 2; prev = e[p]; p += gsize;
                bw.put(7, (d0 * 5 + d1) * 5 + d2);
            }
            if (c != lfe_ch) bw.put(2, 0);             // gainrng
        }
        int baie = blk == 0 ? 1 : 0;
        bw.put(1, baie);
        if (baie) {
            bw.put(2, 2); bw.put(2, 1); bw.put(2, 1);  // sdcy fdcy sgain
            bw.put(2, 2); bw.put(3, 4);                // dbknee floor
        }
        bw.put(1, baie);
        if (baie) {
            bw.put(6, csnr);
            for (int c = 0; c < nch; c++) { bw.put(4, fsnr); bw.put(3, 4); }
        }
        bw.put(1, 0);                                  // deltbaie
        bw.put(1, 0);                                  // skiple

        // grouped-mantissa combine (coefficient order across channels)
        const int32_t* qsrc = qmant + (size_t)blk * nch * 256;
        memcpy(qm, qsrc, (size_t)nch * 256 * 4);
        int m1 = 0, m2 = 0, m4 = 0;
        int32_t *h1 = nullptr, *h2 = nullptr, *h4 = nullptr;
        for (int c = 0; c < nch; c++) {
            const int8_t* bc = bapb + (size_t)c * 256;
            int32_t* qc = qm + (size_t)c * 256;
            int nbc = C.nb[c];
            for (int i = 0; i < nbc; i++) {
                int cls = bc[i];
                int32_t v = qc[i];
                if (cls == 1) {
                    if (m1 == 0) { h1 = qc + i; qc[i] = 9 * v; m1 = 1; }
                    else if (m1 == 1) { *h1 += 3 * v; qc[i] = 128; m1 = 2; }
                    else { *h1 += v; qc[i] = 128; m1 = 0; }
                } else if (cls == 2) {
                    if (m2 == 0) { h2 = qc + i; qc[i] = 25 * v; m2 = 1; }
                    else if (m2 == 1) { *h2 += 5 * v; qc[i] = 128; m2 = 2; }
                    else { *h2 += v; qc[i] = 128; m2 = 0; }
                } else if (cls == 4) {
                    if (m4 == 0) { h4 = qc + i; qc[i] = 11 * v; m4 = 1; }
                    else { *h4 += v; qc[i] = 128; m4 = 0; }
                }
            }
        }
        for (int c = 0; c < nch; c++) {
            const int8_t* bc = bapb + (size_t)c * 256;
            const int32_t* qc = qm + (size_t)c * 256;
            int nbc = C.nb[c];
            for (int i = 0; i < nbc; i++) {
                int cls = bc[i];
                int32_t q = qc[i];
                if (cls == 0) continue;
                if (cls == 1 || cls == 2 || cls == 4) {
                    if (q != 128) bw.put(cls == 1 ? 5 : 7, (uint32_t)q);
                } else if (cls == 3) bw.put(3, (uint32_t)q);
                else if (cls == 14) bw.put(14, (uint32_t)q);
                else if (cls == 15) bw.put(16, (uint32_t)q);
                else bw.put(cls - 1, (uint32_t)q);
            }
        }
    }

    bw.flushz();
    // zero fill + dual CRC (release-build overshoot semantics: crc2
    // overwrites the last payload byte on the odd 44.1 kHz sizes)
    int total = C.frame_size * 2;
    int fs58 = (C.frame_size >> 1) + (C.frame_size >> 3);
    memset(out, 0, total);
    size_t n = bw.buf.size();
    if ((int)n > total - 2) n = total - 2;
    memcpy(out, bw.buf.data(), n);
    uint16_t crc1 = ac3_crc(out + 4, (size_t)2 * fs58 - 4, 0);
    crc1 = (uint16_t)mul_poly(C.crc_inv, crc1, CRC16_POLY);
    out[2] = (uint8_t)(crc1 >> 8);
    out[3] = (uint8_t)(crc1 & 0xFF);
    uint16_t crc2 = ac3_crc(out + 2 * fs58, (size_t)(total - 2) - 2 * fs58, 0);
    out[total - 2] = (uint8_t)(crc2 >> 8);
    out[total - 1] = (uint8_t)(crc2 & 0xFF);
}

extern "C" void ac3h_pack_frames(
    const int32_t* cfgv,          // [8]: fscod frmsizecod halfratecod acmod
                                  //      lfe nch nf frame_size
    const int32_t* nb_coefs,      // [nch]
    int64_t nframes,              // flattened frame count
    const int8_t* bap,            // [n, 6, nch, 256]
    const int32_t* qmant,         // [n, 6, nch, 256]
    const uint8_t* enc_exp,       // [n, 6, nch, 256]
    const int32_t* strat,         // [n, 6, nch]
    const int32_t* csnr,          // [n]
    const int32_t* fsnr,          // [n]
    uint8_t* out,                 // [n, frame_size*2]
    int nthreads)
{
    crc_init();
    PackCfg C;
    C.fscod = cfgv[0]; C.frmsizecod = cfgv[1]; C.halfratecod = cfgv[2];
    C.acmod = cfgv[3]; C.lfe = cfgv[4]; C.nch = cfgv[5]; C.nf = cfgv[6];
    C.frame_size = cfgv[7];
    for (int c = 0; c < C.nch; c++) C.nb[c] = nb_coefs[c];
    int fs58 = (C.frame_size >> 1) + (C.frame_size >> 3);
    C.crc_inv = pow_poly(CRC16_POLY >> 1, 16 * fs58 - 16, CRC16_POLY);

    const size_t sq = (size_t)6 * C.nch * 256;
    const size_t ss = (size_t)6 * C.nch;
    const size_t so = (size_t)C.frame_size * 2;
    auto work = [&](int64_t f) {
        pack_one(C, bap + f * sq, qmant + f * sq, enc_exp + f * sq,
                 strat + f * ss, csnr[f], fsnr[f], out + f * so);
    };
    if (nthreads <= 1 || nframes <= 1) {
        for (int64_t f = 0; f < nframes; f++) work(f);
        return;
    }
    std::atomic<int64_t> next{0};
    int nt = nthreads < (int)nframes ? nthreads : (int)nframes;
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; t++)
        pool.emplace_back([&]() {
            for (;;) {
                int64_t f = next.fetch_add(1);
                if (f >= nframes) return;
                work(f);
            }
        });
    for (auto& th : pool) th.join();
}

// sample-type variants (LIBA52_FIXED / LIBA52_DOUBLE semantics): templated
// over arithmetic traits, sharing this TU's bit reader, allocator and tables
#include "ac3sample.inc"
