// GIF LZW decoder, the host core of the port's GIF documents (page images
// are drawn without PIL, which the card's machine lacks).
//
// Decodes one frame's LZW stream (the image data's sub-blocks joined,
// their length bytes removed) into palette indexes in stream order, as
// Pillow's GifDecode.c reads it: variable code widths from the minimum
// code size + 1 up to 12 bits, least significant bit first; a clear code
// resets the table, the end code ends the frame; a full table (4096
// entries) is kept until the next clear code. The caller lays the
// indexes out (rows, interlace) and composites the frames.
//
// C interface (ctypes, native/build.py):
//   long long dial_gif_lzw(data, n, min_code_size, out, out_len)
//     -> the number of indexes written (at most out_len; the stream may
//        end sooner), or -1 for a code the table does not hold, or a
//        minimum code size outside 1..11.

#include <cstdint>
#include <vector>

namespace {

constexpr int kMaxCodes = 4096;

long long lzw(const uint8_t* data, long long n, int min_size, uint8_t* out, long long out_len) {
  if (min_size < 1 || min_size > 11) return -1;
  const int clear = 1 << min_size, end = clear + 1;
  // each code: its prefix code and its last index; strings are written
  // backwards from the code's length
  std::vector<int16_t> prefix(kMaxCodes);
  std::vector<uint8_t> suffix(kMaxCodes), first(kMaxCodes);
  std::vector<int32_t> length(kMaxCodes);
  for (int c = 0; c < clear; c++) {
    prefix[c] = -1;
    suffix[c] = uint8_t(c);
    first[c] = uint8_t(c);
    length[c] = 1;
  }
  int size = min_size + 1, next = end + 1, previous = -1;
  uint32_t bits = 0;
  int nbits = 0;
  long long pos = 0, written = 0;
  while (written < out_len) {
    while (nbits < size && pos < n) {
      bits |= uint32_t(data[pos++]) << nbits;
      nbits += 8;
    }
    if (nbits < size) break;  // the stream ends before the frame is full
    int code = int(bits & ((1u << size) - 1));
    bits >>= size;
    nbits -= size;
    if (code == clear) {
      size = min_size + 1;
      next = end + 1;
      previous = -1;
      continue;
    }
    if (code == end) break;
    int emit;
    if (previous < 0) {
      if (code >= clear) return -1;
      emit = code;
    } else if (code < next) {
      emit = code;
      if (next < kMaxCodes) {
        prefix[next] = int16_t(previous);
        suffix[next] = first[code];
        first[next] = first[previous];
        length[next] = length[previous] + 1;
        if (++next == (1 << size) && size < 12) size++;
      }
    } else if (code == next && next < kMaxCodes) {
      // the string of the previous code followed by its own first index
      prefix[next] = int16_t(previous);
      suffix[next] = first[previous];
      first[next] = first[previous];
      length[next] = length[previous] + 1;
      if (++next == (1 << size) && size < 12) size++;
      emit = code;
    } else {
      return -1;
    }
    // write the string of ``emit`` (clipped at the frame's end)
    long long len = length[emit];
    long long keep = len < out_len - written ? len : out_len - written;
    int c = emit;
    for (long long i = len - 1; i >= 0; i--) {
      if (i < keep) out[written + i] = suffix[c];
      c = prefix[c];
    }
    written += keep;
    previous = emit;
  }
  return written;
}

}  // namespace

extern "C" {

long long dial_gif_lzw(const uint8_t* data, long long n, int min_code_size, uint8_t* out, long long out_len) {
  try {
    return lzw(data, n, min_code_size, out, out_len);
  } catch (...) {  // no exception crosses the C interface (an allocation that fails)
    return -1;
  }
}

}  // extern "C"
