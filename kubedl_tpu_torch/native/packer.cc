// Native document packer: the data loader's host hot path.
//
// Greedy first-fit packing of variable-length token documents into fixed
// [rows, seq_len+1] training rows (tokens / segment ids / positions),
// bit-identical to the Python loop of
// kubedl_tpu_torch/train/data.py:pack_documents (the loop remains the
// plain version and the spec; tests/test_torch_native.py pins equality).
// Packing is byte shuffling over int32 streams, host work that would
// starve the card's input pipeline in Python when the corpus is large.
//
// Build: kubedl_tpu_torch.native.ensure_built() (the host C++ compiler,
// -O2 -shared -fPIC, no dependencies) into build/kubedl_tpu_torch/.
// Load:  kubedl_tpu_torch.native (ctypes).

#include <cstdint>

extern "C" {

// Packs n_docs documents (flattened into `flat`, lengths in doc_lens)
// into rows of seq_len+1 slots. out_* must hold max_rows * (seq_len+1)
// int32 each. Returns the number of rows written (the trailing partial
// row, if any, is flushed — matching the Python generator's tail), or
// -1 if max_rows would be exceeded (caller sized the buffers wrong).
long kubedl_pack_rows(const int32_t* flat, const int64_t* doc_lens,
                      long n_docs, long seq_len, int32_t pad_id,
                      int32_t* out_tokens, int32_t* out_segs,
                      int32_t* out_pos, long max_rows) {
    const long seq1 = seq_len + 1;
    long row_len = 0;       // filled slots in the current (open) row
    int32_t seg_id = 0;     // per-row segment counter
    long n_rows = 0;        // completed rows

    auto flush = [&]() {
        int32_t* t = out_tokens + n_rows * seq1;
        int32_t* s = out_segs + n_rows * seq1;
        int32_t* p = out_pos + n_rows * seq1;
        for (long i = row_len; i < seq1; ++i) {
            t[i] = pad_id;
            s[i] = -1;
            p[i] = 0;
        }
        ++n_rows;
        row_len = 0;
        seg_id = 0;
    };

    const int32_t* doc = flat;
    for (long d = 0; d < n_docs; ++d) {
        const long len = doc_lens[d];
        for (long start = 0; start < len; start += seq1) {
            long clen = len - start;
            if (clen > seq1) clen = seq1;
            if (clen < 2) continue;  // no (input, target) pair
            if (row_len + clen > seq1) {
                if (n_rows >= max_rows) return -1;
                flush();
            }
            if (n_rows >= max_rows) return -1;
            int32_t* t = out_tokens + n_rows * seq1 + row_len;
            int32_t* s = out_segs + n_rows * seq1 + row_len;
            int32_t* p = out_pos + n_rows * seq1 + row_len;
            for (long i = 0; i < clen; ++i) {
                t[i] = doc[start + i];
                s[i] = seg_id;
                p[i] = static_cast<int32_t>(i);
            }
            row_len += clen;
            ++seg_id;
            if (row_len == seq1) {
                if (n_rows >= max_rows) return -1;
                flush();
            }
        }
        doc += len;
    }
    if (row_len) {
        if (n_rows >= max_rows) return -1;
        flush();
    }
    return n_rows;
}

}  // extern "C"
