// One move of the run-jump traceback, shared by the walk over full records
// (csrc/walk.cu) and the checkpoint walk (csrc/walk_ckpt.cu). Its plain
// twin is pangraph_tpu_torch/ops/stripe_v2.py:_Walker.
//
// A record (read as unsigned 16-bit) holds origin bits 0-5 and the diagonal
// MATCH run ending at the cell in bits 6-15. A MATCH move jumps the whole
// run at once, stopping at a floor row (the caller's segment or window
// edge), and keeps the rows left of the run in rr. Events go straight to
// rows/words[K]: a deletion run is one event at its lowest row, a match row
// followed by an insertion run is one. Events past K land in slot K-1 while
// the count keeps going, so n_events > K reports an overflow.
#pragma once

#include "stripe_row.cuh"

namespace walkstep {

using stripe::BOUNDARY;
using stripe::MATCH;
using stripe::QRY_GAP_EXTEND;
using stripe::QRY_GAP_MATRIX;
using stripe::REF_GAP_EXTEND;
using stripe::REF_GAP_MATRIX;

constexpr unsigned OP_M = 1;
constexpr unsigned OP_D = 2;

struct Walker {
    int i, q;             // current cell: row i, query position q
    int st, ins, dl, ia;  // gap state, insertion run, deletion run, insertion after it
    int cnt, dead, bnd;   // events so far, walk died, a cell touched the band edge
    int rr;               // rows of the last match run left below where its jump stopped
};

__device__ __forceinline__ Walker walker(int rlen, int qlen) {
    Walker w;
    w.i = rlen;
    w.q = qlen;
    w.st = w.ins = w.dl = w.ia = w.cnt = w.dead = w.bnd = w.rr = 0;
    return w;
}

__device__ __forceinline__ int del_word(int ia, int dl) {
    return (int)(OP_D | ((unsigned)ia << 2) | ((unsigned)dl << 17));
}

__device__ __forceinline__ void emit(Walker& w, int row, int word, int K, int* rows_p, int* words_p) {
    const int idx = min(w.cnt, K - 1);
    rows_p[idx] = row;
    words_p[idx] = word;
    ++w.cnt;
}

// One move from `word`, the record of cell (i, q) (0 when out of band); a
// match jump stops at row `floor`.
__device__ __forceinline__ void walk_move(Walker& w, int word, int floor, int K, int* rows_p, int* words_p) {
    const int bits = word & 63;
    const int runv = word >> 6;
    if (bits & BOUNDARY) w.bnd = 1;
    const bool take_m = w.st == 0 && (bits & MATCH);
    const bool take_i = (w.st == 0 && (bits & REF_GAP_MATRIX) && !take_m) || w.st == REF_GAP_MATRIX;
    const bool take_d = (w.st == 0 && (bits & QRY_GAP_MATRIX) && !take_m && !take_i) || w.st == QRY_GAP_MATRIX;
    if (bits == 0 || !(take_m || take_i || take_d)) {
        w.dead = 1;
        w.rr = 0;
        return;
    }
    const bool emit_d = (take_m || take_i) && w.dl > 0;
    if (emit_d)
        emit(w, w.i, del_word(w.ia, w.dl), K, rows_p, words_p);
    else if (take_m && w.ins > 0 && w.dl == 0)
        emit(w, w.i - 1, (int)(OP_M | ((unsigned)w.ins << 2)), K, rows_p, words_p);
    const int new_ia = (take_d && w.dl == 0) ? w.ins : (emit_d ? 0 : w.ia);
    w.dl = take_d ? w.dl + 1 : (emit_d ? 0 : w.dl);
    w.ia = new_ia;
    w.rr = 0;
    if (take_m) {
        const int run = max(runv, 1);
        const int L = min(run, w.i - floor);
        w.i -= L;
        w.q -= L;
        w.ins = 0;
        w.rr = run - L;
    } else if (take_d) {
        w.i -= 1;
        w.ins = 0;
        w.st = (bits & QRY_GAP_EXTEND) ? QRY_GAP_MATRIX : 0;
    } else {
        w.q -= 1;
        w.ins += 1;
        w.st = (bits & REF_GAP_EXTEND) ? REF_GAP_MATRIX : 0;
    }
}

// End of the walk: a deletion run reaching row 0 is flushed once; then the
// event count and meta (lead insertion, dead, boundary, pending insertion).
__device__ __forceinline__ void walk_finish(Walker& w, int K, int* rows_p, int* words_p, int* nev_p, int* meta_p) {
    if (w.i == 0 && !w.dead && w.dl > 0) emit(w, 0, del_word(w.ia, w.dl), K, rows_p, words_p);
    *nev_p = w.cnt;
    meta_p[0] = w.q;
    meta_p[1] = w.dead | (w.i > 0 ? 1 : 0);
    meta_p[2] = w.bnd;
    meta_p[3] = w.ins;
}

}  // namespace walkstep
