// WebP image decoders, the host core of the port's WebP documents (page
// images are drawn without PIL, which the card's machine lacks).
//
// Each entry point decodes one image bitstream of a WebP file, as libwebp
// (the library Pillow's WebP plugin calls) decodes it:
//   - VP8 key frames (RFC 6386): the boolean decoder with libwebp's
//     register layout (its prob-128 sign read shifts one bit whatever the
//     range), segment and filter headers, token partitions, dequantisation
//     (libwebp's y2 AC factor, x * 155 / 100 as (x * 101581) >> 16, at
//     least 8), intra prediction on libwebp's edges (127 above the frame,
//     129 left of it, the top-right of the last macroblock column
//     replicated), the inverse WHT and DCT, then the simple or normal loop
//     filter over the whole frame in macroblock order; then libwebp's fancy
//     upsampling of the chroma (upsampling.c) and its 14-bit fixed-point
//     YUV -> RGB (yuv.h), so the output equals libwebp's bit for bit;
//   - VP8L lossless images: prefix codes (simple and normal, the code-
//     length code and its repeats), meta prefix codes, LZ77 with the 120
//     plane-distance codes and the colour cache, and the predictor (14
//     modes), cross-colour, subtract-green and colour-indexing transforms
//     undone in reverse order;
//   - ALPH chunks: raw or VP8L-compressed (the green channel of an image
//     stream without header), then the horizontal, vertical or gradient
//     filter undone. The level-reduction flag changes nothing, as libwebp
//     dequantises only when asked to dither alpha, which Pillow does not.
// Coefficient probabilities, their update probabilities, the intra-4x4
// mode probabilities (in libwebp's mode order: DC, TM, VE, HE, RD, VR, LD,
// VL, HD, HU), the quantiser tables and the plane-distance codes are the
// specifications' tables.
//
// C interface (ctypes, native/build.py); status 0 ok, 1 corrupt, 2 not a
// key frame (a VP8 inter frame, which libwebp refuses in a WebP too):
//   int dial_webp_vp8_info(data, n, info[2])      -> width, height
//   int dial_webp_vp8_decode(data, n, rgba, width, height)
//     -> R, G and B of each [height, width, 4] pixel (A untouched)
//   int dial_webp_vp8l_info(data, n, info[3])     -> width, height, alpha bit
//   int dial_webp_vp8l_decode(data, n, rgba, width, height)
//   int dial_webp_alpha(data, n, width, height, alpha [height, width])

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int OK = 0;
constexpr int CORRUPT = 1;
constexpr int UNSUPPORTED = 2;

// -- VP8 tables -------------------------------------------------------------------

constexpr uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};
constexpr uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};
constexpr uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24};
constexpr uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112};
constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's mode numbers: the 16x16 and chroma modes share the first four
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED,
       B_HU_PRED };
enum { DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED };

// -- the boolean decoder ------------------------------------------------------------

int log2_floor(uint32_t v) {
  int r = 0;
  while (v >>= 1) r++;
  return r;
}

// libwebp's VP8BitReader, loading a byte at a time: ``range`` holds the
// range minus one, ``bits`` the bits of ``value`` below the 8-bit window
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    buf = start;
    end = start + size;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = uint32_t(value >> pos);
    int b;
    if (v > split) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    const int shift = 7 ^ log2_floor(r);
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  // VP8GetSigned: a prob-128 bit that always shifts by one
  int sign(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = uint32_t(value >> pos);
    const int32_t mask = int32_t(split - val) >> 31;
    bits -= 1;
    range += uint32_t(mask);
    range |= 1;
    value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value_bits(n);
    return value_bits(1) ? -v : v;
  }
};

// -- VP8 ----------------------------------------------------------------------------

constexpr int BPS = 32;  // the work buffers' stride

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t uvmode = 0;
  uint8_t segment = 0;
  bool is_i4x4 = false;
  bool skip = false;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct FInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct Vp8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int8_t quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segment_probs[3] = {255, 255, 255};
  // filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, filter_type = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  // quantisers per segment: y1, y2, uv (dc, ac)
  int y1[4][2], y2[4][2], uv[4][2];
  uint8_t bands[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];
  BoolReader br;
  std::vector<BoolReader> parts;
};

int parse_headers(Vp8& d, const uint8_t* data, size_t n) {
  if (n < 10) return CORRUPT;
  const uint32_t tag = data[0] | (data[1] << 8) | (data[2] << 16);
  const bool key_frame = !(tag & 1);
  const int profile = (tag >> 1) & 7;
  const bool show = (tag >> 4) & 1;
  const uint32_t partition_length = tag >> 5;
  if (!key_frame) return UNSUPPORTED;
  if (profile > 3 || !show) return CORRUPT;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return CORRUPT;
  d.width = ((data[7] << 8) | data[6]) & 0x3fff;
  d.height = ((data[9] << 8) | data[8]) & 0x3fff;
  if (!d.width || !d.height) return CORRUPT;
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  const uint8_t* buf = data + 10;
  size_t left = n - 10;
  if (partition_length > left) return CORRUPT;
  BoolReader& br = d.br;
  br.init(buf, partition_length);
  buf += partition_length;
  left -= partition_length;
  br.value_bits(1);  // colour space
  br.value_bits(1);  // clamping type
  // segments
  d.use_segment = br.value_bits(1);
  if (d.use_segment) {
    d.update_map = br.value_bits(1);
    if (br.value_bits(1)) {
      d.absolute_delta = br.value_bits(1);
      for (int s = 0; s < 4; s++) d.quantizer[s] = int8_t(br.value_bits(1) ? br.signed_value(7) : 0);
      for (int s = 0; s < 4; s++) d.filter_strength[s] = int8_t(br.value_bits(1) ? br.signed_value(6) : 0);
    }
    if (d.update_map) {
      for (int s = 0; s < 3; s++) d.segment_probs[s] = uint8_t(br.value_bits(1) ? br.value_bits(8) : 255);
    }
  }
  // filter
  d.simple = br.value_bits(1);
  d.level = br.value_bits(6);
  d.sharpness = br.value_bits(3);
  d.use_lf_delta = br.value_bits(1);
  if (d.use_lf_delta && br.value_bits(1)) {
    for (int i = 0; i < 4; i++) {
      if (br.value_bits(1)) d.ref_lf_delta[i] = br.signed_value(6);
    }
    for (int i = 0; i < 4; i++) {
      if (br.value_bits(1)) d.mode_lf_delta[i] = br.signed_value(6);
    }
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof) return CORRUPT;
  // partitions
  const size_t last = (size_t(1) << br.value_bits(2)) - 1;
  if (left < 3 * last) return CORRUPT;
  const uint8_t* sizes = buf;
  const uint8_t* start = buf + 3 * last;
  size_t size_left = left - 3 * last;
  d.parts.assign(last + 1, BoolReader());
  for (size_t p = 0; p < last; p++) {
    size_t psize = sizes[0] | (sizes[1] << 8) | (sizes[2] << 16);
    if (psize > size_left) psize = size_left;
    d.parts[p].init(start, psize);
    start += psize;
    size_left -= psize;
    sizes += 3;
  }
  d.parts[last].init(start, size_left);
  if (start >= data + n) return CORRUPT;
  // quantisers
  const int base_q0 = br.value_bits(7);
  const int dqy1_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dqy2_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dqy2_ac = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dquv_dc = br.value_bits(1) ? br.signed_value(4) : 0;
  const int dquv_ac = br.value_bits(1) ? br.signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int s = 0; s < 4; s++) {
    int q;
    if (d.use_segment) {
      q = d.quantizer[s];
      if (!d.absolute_delta) q += base_q0;
    } else {
      if (s > 0) {
        std::memcpy(d.y1[s], d.y1[0], sizeof(d.y1[0]));
        std::memcpy(d.y2[s], d.y2[0], sizeof(d.y2[0]));
        std::memcpy(d.uv[s], d.uv[0], sizeof(d.uv[0]));
        continue;
      }
      q = base_q0;
    }
    d.y1[s][0] = kDcTable[clip(q + dqy1_dc, 127)];
    d.y1[s][1] = kAcTable[clip(q, 127)];
    d.y2[s][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    d.y2[s][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (d.y2[s][1] < 8) d.y2[s][1] = 8;
    d.uv[s][0] = kDcTable[clip(q + dquv_dc, 117)];
    d.uv[s][1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.value_bits(1);  // update_proba, ignored for a key frame
  for (int t = 0; t < 4; t++) {
    for (int b = 0; b < 8; b++) {
      for (int c = 0; c < 3; c++) {
        for (int p = 0; p < 11; p++) {
          const int k = ((t * 8 + b) * 3 + c) * 11 + p;
          d.bands[t][b][c][p] = uint8_t(br.bit(kCoeffsUpdateProba[k]) ? br.value_bits(8) : kCoeffsProba0[k]);
        }
      }
    }
  }
  d.use_skip = br.value_bits(1);
  if (d.use_skip) d.skip_p = br.value_bits(8);
  // filter strengths per segment and block kind
  if (d.filter_type > 0) {
    for (int s = 0; s < 4; s++) {
      int base_level;
      if (d.use_segment) {
        base_level = d.filter_strength[s];
        if (!d.absolute_delta) base_level += d.level;
      } else {
        base_level = d.level;
      }
      for (int i4x4 = 0; i4x4 <= 1; i4x4++) {
        FInfo& info = d.fstrengths[s][i4x4];
        int level = base_level;
        if (d.use_lf_delta) {
          level += d.ref_lf_delta[0];
          if (i4x4) level += d.mode_lf_delta[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (d.sharpness > 0) {
            ilevel >>= d.sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }
  return OK;
}

void parse_intra_mode(Vp8& d, BoolReader& br, MBData& block, uint8_t* top, uint8_t* left) {
  if (d.update_map) {
    block.segment = uint8_t(!br.bit(d.segment_probs[0]) ? br.bit(d.segment_probs[1])
                                                          : br.bit(d.segment_probs[2]) + 2);
  } else {
    block.segment = 0;
  }
  block.skip = d.use_skip ? br.bit(d.skip_p) : false;
  block.is_i4x4 = !br.bit(145);
  if (!block.is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED) : (br.bit(163) ? V_PRED : DC_PRED);
    block.imodes[0] = uint8_t(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; y++) {
      int ymode = left[y];
      for (int x = 0; x < 4; x++) {
        const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
        ymode = !br.bit(prob[0])   ? B_DC_PRED
                : !br.bit(prob[1]) ? B_TM_PRED
                : !br.bit(prob[2]) ? B_VE_PRED
                : !br.bit(prob[3]) ? (!br.bit(prob[4]) ? B_HE_PRED : (!br.bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                                   : (!br.bit(prob[6]) ? B_LD_PRED
                                      : (!br.bit(prob[7]) ? B_VL_PRED : (!br.bit(prob[8]) ? B_HD_PRED : B_HU_PRED)));
        top[x] = uint8_t(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = uint8_t(ymode);
    }
  }
  block.uvmode = uint8_t(!br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED);
}

int large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  } else if (!br.bit(p[6])) {
    if (!br.bit(p[7])) {
      v = 5 + br.bit(159);
    } else {
      v = 7 + 2 * br.bit(165);
      v += br.bit(145);
    }
  } else {
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// the coefficients of one 4x4 block from position n: the position after the last non-zero one
int get_coeffs(Vp8& d, BoolReader& br, int type, int ctx, const int dq[2], int n, int16_t* out) {
  const uint8_t* p = d.bands[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = d.bands[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = d.bands[type][kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = d.bands[type][kBands[n + 1]][2];
    }
    out[kZigzag[n]] = int16_t(br.sign(v) * dq[n > 0]);
  }
  return 16;
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

// ParseResiduals: true where the macroblock has no non-zero coefficient
bool parse_residuals(Vp8& d, BoolReader& br, MBData& block, uint8_t& top_nz, uint8_t& top_nz_dc, uint8_t& left_nz,
                     uint8_t& left_nz_dc) {
  int16_t* dst = block.coeffs;
  std::memset(dst, 0, sizeof(block.coeffs));
  const int s = block.segment;
  int first, ac_type;
  if (!block.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = top_nz_dc + left_nz_dc;
    const int nz = get_coeffs(d, br, 1, ctx, d.y2[s], 0, dc);
    top_nz_dc = left_nz_dc = uint8_t(nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  uint8_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(d, br, ac_type, ctx, d.y1[s], first, dst);
      l = nz > first;
      tnz = uint8_t((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = uint8_t((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = uint8_t(top_nz >> (4 + ch));
    lnz = uint8_t(left_nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(d, br, 2, ctx, d.uv[s], 0, dst);
        l = nz > 0;
        tnz = uint8_t((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = uint8_t((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= uint32_t(tnz << 4) << ch;
    out_l_nz |= uint32_t(lnz & 0xf0) << ch;
  }
  top_nz = uint8_t(out_t_nz);
  left_nz = uint8_t(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
  int c[16];
  int* tmp = c;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int cc = mul2(in[4]) - mul1(in[12]);
    const int dd = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + dd;
    tmp[1] = b + cc;
    tmp[2] = b - cc;
    tmp[3] = a - dd;
    tmp += 4;
    in++;
  }
  tmp = c;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int cc = mul2(tmp[4]) - mul1(tmp[12]);
    const int dd = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + dd) >> 3));
    dst[1] = clip8(dst[1] + ((b + cc) >> 3));
    dst[2] = clip8(dst[2] + ((b - cc) >> 3));
    dst[3] = clip8(dst[3] + ((a - dd) >> 3));
    tmp++;
    dst += BPS;
  }
}

void add_residual(const int16_t* coeffs, uint8_t* dst) {
  for (int i = 0; i < 16; i++) {
    if (coeffs[i]) {
      transform_one(coeffs, dst);
      return;
    }
  }
}

// -- intra prediction (dsp/dec.c) ---------------------------------------------------

#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}

void predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, int(dc), 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
      std::memset(dst + 0 * BPS, avg3(A, B, C), 4);
      std::memset(dst + 1 * BPS, avg3(B, C, D), 4);
      std::memset(dst + 2 * BPS, avg3(C, D, E), 4);
      std::memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
      const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS];
      const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
      const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    default: {  // B_HU_PRED
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = uint8_t(L);
      break;
    }
  }
}
#undef DST

// 16x16 (size 16) and chroma (size 8) prediction; ``mode`` DC_PRED is
// narrowed by the macroblock's position, as libwebp's CheckMode does
void predict_block(int mode, int size, int mb_x, int mb_y, uint8_t* dst) {
  const int shift = size == 16 ? 4 : 3;
  auto fill = [&](int v) {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size_t(size));
  };
  switch (mode) {
    case DC_PRED: {
      if (mb_x > 0 && mb_y > 0) {
        int dc = size;
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
        fill(dc >> (shift + 1));
      } else if (mb_y > 0) {  // no left samples
        int dc = size >> 1;
        for (int i = 0; i < size; ++i) dc += dst[i - BPS];
        fill(dc >> shift);
      } else if (mb_x > 0) {  // no top samples
        int dc = size >> 1;
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
        fill(dc >> shift);
      } else {
        fill(0x80);
      }
      break;
    }
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size_t(size));
      break;
    default:  // H_PRED
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size_t(size));
      break;
  }
}

// -- the loop filter (dsp/dec.c) ------------------------------------------------------

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int step, int across, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (needs_filter(p + i * across, step, thresh2)) do_filter2(p + i * across, step);
  }
}

// FilterLoop26 (macroblock edges, six taps) and FilterLoop24 (inner edges)
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh,
                 bool edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else if (edge) {
        do_filter6(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

void filter_mb(const Vp8& d, const FInfo& f, int mb_x, int mb_y, uint8_t* y, int ys, uint8_t* u, uint8_t* v,
               int uvs) {
  const int limit = f.limit;
  if (limit == 0) return;
  uint8_t* y_dst = y + (mb_y * 16) * ys + mb_x * 16;
  if (d.filter_type == 1) {
    if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
    if (f.inner) {
      for (int k = 1; k < 4; k++) simple_filter(y_dst + 4 * k, 1, ys, limit);
    }
    if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
    if (f.inner) {
      for (int k = 1; k < 4; k++) simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
    }
    return;
  }
  uint8_t* u_dst = u + (mb_y * 8) * uvs + mb_x * 8;
  uint8_t* v_dst = v + (mb_y * 8) * uvs + mb_x * 8;
  const int ilevel = f.ilevel, hev_t = f.hev_thresh;
  if (mb_x > 0) {
    filter_loop(y_dst, 1, ys, 16, limit + 4, ilevel, hev_t, true);
    filter_loop(u_dst, 1, uvs, 8, limit + 4, ilevel, hev_t, true);
    filter_loop(v_dst, 1, uvs, 8, limit + 4, ilevel, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k < 4; k++) filter_loop(y_dst + 4 * k, 1, ys, 16, limit, ilevel, hev_t, false);
    filter_loop(u_dst + 4, 1, uvs, 8, limit, ilevel, hev_t, false);
    filter_loop(v_dst + 4, 1, uvs, 8, limit, ilevel, hev_t, false);
  }
  if (mb_y > 0) {
    filter_loop(y_dst, ys, 1, 16, limit + 4, ilevel, hev_t, true);
    filter_loop(u_dst, uvs, 1, 8, limit + 4, ilevel, hev_t, true);
    filter_loop(v_dst, uvs, 1, 8, limit + 4, ilevel, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k < 4; k++) filter_loop(y_dst + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t, false);
    filter_loop(u_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, false);
    filter_loop(v_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, false);
  }
}

// -- YUV -> RGB (yuv.h) and fancy upsampling (upsampling.c) -------------------------

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  constexpr int kMask = (256 << 6) - 1;
  return uint8_t((v & ~kMask) == 0 ? (v >> 6) : (v < 0) ? 0 : 255);
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// one output row of UpsampleRgbaLinePair: the pair's top row (``bottom``
// false: chroma nearer ``top_*``) or bottom row (nearer ``cur_*``)
void upsample_row(const uint8_t* y_row, const uint8_t* top_u, const uint8_t* top_v, const uint8_t* cur_u,
                  const uint8_t* cur_v, bool bottom, uint8_t* dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  auto first = [&](int near_u, int near_v, int far_u, int far_v, int x) {
    yuv_to_rgb(y_row[x], (3 * near_u + far_u + 2) >> 2, (3 * near_v + far_v + 2) >> 2, dst + 4 * x);
  };
  if (bottom) {
    first(l_u, l_v, tl_u, tl_v, 0);
  } else {
    first(tl_u, tl_v, l_u, l_v, 0);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    if (!bottom) {
      yuv_to_rgb(y_row[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, dst + 4 * (2 * x - 1));
      yuv_to_rgb(y_row[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, dst + 4 * (2 * x));
    } else {
      yuv_to_rgb(y_row[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1, dst + 4 * (2 * x - 1));
      yuv_to_rgb(y_row[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, dst + 4 * (2 * x));
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    if (bottom) {
      first(l_u, l_v, tl_u, tl_v, len - 1);
    } else {
      first(tl_u, tl_v, l_u, l_v, len - 1);
    }
  }
}

int vp8_decode(const uint8_t* data, size_t n, uint8_t* rgba, int out_w, int out_h) {
  Vp8 d;
  const int status = parse_headers(d, data, n);
  if (status != OK) return status;
  if (d.width != out_w || d.height != out_h) return CORRUPT;
  const int ys = d.mb_w * 16, uvs = d.mb_w * 8;
  std::vector<uint8_t> Y(size_t(ys) * d.mb_h * 16), U(size_t(uvs) * d.mb_h * 8), V(U.size());
  std::vector<uint8_t> intra_t(size_t(4) * d.mb_w, B_DC_PRED);
  std::vector<uint8_t> top_nz(d.mb_w, 0), top_nz_dc(d.mb_w, 0);
  std::vector<FInfo> finfo(size_t(d.mb_w) * d.mb_h);
  std::vector<MBData> row(d.mb_w);
  uint8_t yb[BPS * 17], ub[BPS * 9], vb[BPS * 9];
  uint8_t* const y_dst = yb + BPS + 8;
  uint8_t* const u_dst = ub + BPS + 8;
  uint8_t* const v_dst = vb + BPS + 8;
  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
    uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    uint8_t left_nz = 0, left_nz_dc = 0;
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) parse_intra_mode(d, d.br, row[mb_x], &intra_t[4 * mb_x], intra_l);
    if (d.br.eof) return CORRUPT;
    BoolReader& token_br = d.parts[size_t(mb_y) & (d.parts.size() - 1)];
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      MBData& block = row[mb_x];
      bool skip = d.use_skip ? block.skip : false;
      if (!skip) {
        skip = parse_residuals(d, token_br, block, top_nz[mb_x], top_nz_dc[mb_x], left_nz, left_nz_dc);
      } else {
        left_nz = top_nz[mb_x] = 0;
        if (!block.is_i4x4) left_nz_dc = top_nz_dc[mb_x] = 0;
        block.non_zero_y = block.non_zero_uv = 0;
        std::memset(block.coeffs, 0, sizeof(block.coeffs));
      }
      if (d.filter_type > 0) {
        FInfo& f = finfo[size_t(mb_y) * d.mb_w + mb_x];
        f = d.fstrengths[block.segment][block.is_i4x4];
        f.inner = f.inner || !skip;
      }
      if (token_br.eof) return CORRUPT;
    }
    // reconstruction, from the unfiltered planes
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      const MBData& block = row[mb_x];
      const int x0 = mb_x * 16, y0 = mb_y * 16;
      uint8_t* py = &Y[size_t(y0) * ys + x0];
      uint8_t* pu = &U[size_t(y0 / 2) * uvs + x0 / 2];
      uint8_t* pv = &V[size_t(y0 / 2) * uvs + x0 / 2];
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = mb_x > 0 ? py[j * ys - 1] : 129;
      for (int j = 0; j < 8; ++j) {
        u_dst[j * BPS - 1] = mb_x > 0 ? pu[j * uvs - 1] : 129;
        v_dst[j * BPS - 1] = mb_x > 0 ? pv[j * uvs - 1] : 129;
      }
      if (mb_y > 0) {
        y_dst[-1 - BPS] = mb_x > 0 ? py[-ys - 1] : 129;
        u_dst[-1 - BPS] = mb_x > 0 ? pu[-uvs - 1] : 129;
        v_dst[-1 - BPS] = mb_x > 0 ? pv[-uvs - 1] : 129;
        std::memcpy(y_dst - BPS, py - ys, 16);
        std::memcpy(u_dst - BPS, pu - uvs, 8);
        std::memcpy(v_dst - BPS, pv - uvs, 8);
      } else {
        std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        std::memset(u_dst - BPS - 1, 127, 8 + 1);
        std::memset(v_dst - BPS - 1, 127, 8 + 1);
      }
      if (block.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= d.mb_w - 1) {
            std::memset(top_right, py[-ys + 15], 4);
          } else {
            std::memcpy(top_right, py - ys + 16, 4);
          }
        }
        for (int k = 1; k <= 3; k++) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int b = 0; b < 16; ++b) {
          uint8_t* dst = y_dst + (b >> 2) * 4 * BPS + (b & 3) * 4;
          predict4(block.imodes[b], dst);
          add_residual(block.coeffs + b * 16, dst);
        }
      } else {
        predict_block(block.imodes[0], 16, mb_x, mb_y, y_dst);
        for (int b = 0; b < 16; ++b) add_residual(block.coeffs + b * 16, y_dst + (b >> 2) * 4 * BPS + (b & 3) * 4);
      }
      predict_block(block.uvmode, 8, mb_x, mb_y, u_dst);
      predict_block(block.uvmode, 8, mb_x, mb_y, v_dst);
      for (int b = 0; b < 4; ++b) {
        add_residual(block.coeffs + 256 + b * 16, u_dst + (b >> 1) * 4 * BPS + (b & 1) * 4);
        add_residual(block.coeffs + 320 + b * 16, v_dst + (b >> 1) * 4 * BPS + (b & 1) * 4);
      }
      for (int j = 0; j < 16; ++j) std::memcpy(py + j * ys, y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(pu + j * uvs, u_dst + j * BPS, 8);
        std::memcpy(pv + j * uvs, v_dst + j * BPS, 8);
      }
    }
  }
  if (d.filter_type > 0) {
    for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
      for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
        filter_mb(d, finfo[size_t(mb_y) * d.mb_w + mb_x], mb_x, mb_y, Y.data(), ys, U.data(), V.data(), uvs);
      }
    }
  }
  // fancy upsampling into RGBA rows (alpha left as it is)
  const int w = d.width, h = d.height, stride = 4 * w;
  std::vector<uint8_t> line(size_t(stride), 0);
  auto emit = [&](int y, const uint8_t* tu, const uint8_t* tv, const uint8_t* cu, const uint8_t* cv, bool bottom) {
    upsample_row(&Y[size_t(y) * ys], tu, tv, cu, cv, bottom, line.data(), w);
    uint8_t* out = rgba + size_t(y) * stride;
    for (int x = 0; x < w; ++x) std::memcpy(out + 4 * x, line.data() + 4 * x, 3);
  };
  auto urow = [&](int k) { return &U[size_t(k) * uvs]; };
  auto vrow = [&](int k) { return &V[size_t(k) * uvs]; };
  emit(0, urow(0), vrow(0), urow(0), vrow(0), false);
  for (int k = 1; 2 * k - 1 < h; ++k) {
    if (2 * k < h) {
      emit(2 * k - 1, urow(k - 1), vrow(k - 1), urow(k), vrow(k), false);
      emit(2 * k, urow(k - 1), vrow(k - 1), urow(k), vrow(k), true);
    } else {  // the last row of an even height
      emit(2 * k - 1, urow(k - 1), vrow(k - 1), urow(k - 1), vrow(k - 1), false);
    }
  }
  return OK;
}

// -- VP8L ---------------------------------------------------------------------------

// least significant bit first
struct BitReader {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;  // in bits
  bool eos = false;
  uint32_t read(int count) {
    uint32_t v = 0;
    for (int k = 0; k < count; k++) {
      const size_t p = pos + size_t(k);
      if ((p >> 3) >= n) {
        eos = true;
        continue;
      }
      v |= uint32_t((data[p >> 3] >> (p & 7)) & 1) << k;
    }
    pos += size_t(count);
    return v;
  }
  // the next 16 bits without consuming them (zeros past the end)
  uint32_t peek16() const {
    const size_t at = pos >> 3;
    uint32_t w = 0;
    for (int k = 0; k < 4; k++) w |= uint32_t(at + k < n ? data[at + k] : 0) << (8 * k);
    return (w >> (pos & 7)) & 0xFFFF;
  }
};

constexpr int kPrimaryBits = 9;

// a canonical prefix code read most significant code bit first from the
// least-significant-first stream, by a 9-bit table and bit-by-bit beyond it
struct Huffman {
  bool single = false;  // one symbol: no bits are read
  int symbol = 0;
  std::vector<int> counts, symbols, offsets;
  std::vector<uint16_t> table;  // (length << 12) | symbol, 0 for longer codes
  int max_len = 0;

  bool build(const std::vector<int>& lengths) {
    int nonzero = 0, last = 0;
    for (size_t s = 0; s < lengths.size(); s++) {
      if (lengths[s]) {
        nonzero++;
        last = int(s);
      }
    }
    if (nonzero == 0) return false;
    if (nonzero == 1) {
      single = true;
      symbol = last;
      return true;
    }
    counts.assign(16, 0);
    for (int l : lengths) {
      if (l > 15) return false;
      counts[l]++;
    }
    counts[0] = 0;
    // the code must be complete
    int left = 1;
    for (int len = 1; len < 16; len++) {
      left <<= 1;
      left -= counts[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    offsets.assign(16, 0);
    for (int len = 1; len < 15; len++) offsets[len + 1] = offsets[len] + counts[len];
    symbols.assign(lengths.size(), 0);
    std::vector<int> next = offsets;
    for (size_t s = 0; s < lengths.size(); s++) {
      if (lengths[s]) symbols[size_t(next[lengths[s]]++)] = int(s);
    }
    max_len = 0;
    for (int len = 1; len < 16; len++) {
      if (counts[len]) max_len = len;
    }
    // the table: for each code of at most kPrimaryBits, its bit-reversed slots
    table.assign(size_t(1) << kPrimaryBits, 0);
    int code = 0, index = 0;
    for (int len = 1; len <= kPrimaryBits; len++) {
      for (int k = 0; k < counts[len]; k++) {
        int rev = 0;
        for (int b = 0; b < len; b++) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int slot = rev; slot < (1 << kPrimaryBits); slot += 1 << len) {
          table[size_t(slot)] = uint16_t((len << 12) | symbols[size_t(index)]);
        }
        code++;
        index++;
      }
      code <<= 1;
    }
    return true;
  }

  int read(BitReader& br) const {
    if (single) return symbol;
    const uint32_t bits = br.peek16();
    const uint16_t e = table[bits & ((1u << kPrimaryBits) - 1)];
    if (e) {
      br.pos += size_t(e >> 12);
      if (br.pos > br.n * 8) br.eos = true;
      return e & 0xFFF;
    }
    // canonical decoding, a bit at a time
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; len++) {
      code |= int(br.read(1));
      const int count = counts[len];
      if (code - count < first) return symbols[size_t(index + (code - first))];
      index += count;
      first += count;
      first <<= 1;
      code <<= 1;
    }
    br.eos = true;
    return 0;
  }
};

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

bool read_huffman(BitReader& br, int alphabet, Huffman& out) {
  std::vector<int> lengths(size_t(alphabet), 0);
  if (br.read(1)) {  // simple code
    const int num_symbols = int(br.read(1)) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    const int s0 = int(br.read(first_bits));
    if (s0 >= alphabet) return false;
    lengths[size_t(s0)] = 1;
    if (num_symbols == 2) {
      const int s1 = int(br.read(8));
      if (s1 >= alphabet) return false;
      lengths[size_t(s1)] = 1;
    }
  } else {
    std::vector<int> cl(19, 0);
    const int num_codes = int(br.read(4)) + 4;
    for (int i = 0; i < num_codes; i++) cl[size_t(kCodeLengthOrder[i])] = int(br.read(3));
    Huffman lengths_code;
    if (!lengths_code.build(cl)) return false;
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int length_nbits = 2 + 2 * int(br.read(3));
      max_symbol = 2 + int(br.read(length_nbits));
      if (max_symbol > alphabet) return false;
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int code_len = lengths_code.read(br);
      if (code_len < 16) {
        lengths[size_t(symbol++)] = code_len;
        if (code_len) prev = code_len;
      } else {
        static const int kExtraBits[3] = {2, 3, 7};
        static const int kOffsets[3] = {3, 3, 11};
        const int slot = code_len - 16;
        const int repeat = int(br.read(kExtraBits[slot])) + kOffsets[slot];
        if (symbol + repeat > alphabet) return false;
        const int length = code_len == 16 ? prev : 0;
        for (int k = 0; k < repeat; k++) lengths[size_t(symbol++)] = length;
      }
    }
  }
  if (br.eos) return false;
  return out.build(lengths);
}

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline int prefix_value(int symbol, BitReader& br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + int(br.read(extra)) + 1;
}

inline int sub_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

bool decode_image_stream(BitReader& br, int xsize, int ysize, bool level0, std::vector<uint32_t>& out,
                         std::vector<Transform>* transforms);

// the entropy-coded pixels of an image stream after its transforms
bool decode_pixels(BitReader& br, int xsize, int ysize, bool level0, std::vector<uint32_t>& out) {
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = int(br.read(4));
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;
  int num_groups = 1;
  if (level0 && br.read(1)) {
    huffman_bits = int(br.read(3)) + 2;
    huffman_xsize = sub_size(xsize, huffman_bits);
    if (!decode_image_stream(br, huffman_xsize, sub_size(ysize, huffman_bits), false, huffman_image, nullptr)) {
      return false;
    }
    for (uint32_t& p : huffman_image) {
      p = (p >> 8) & 0xffff;
      if (int(p) + 1 > num_groups) num_groups = int(p) + 1;
    }
  }
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  std::vector<Huffman> codes(size_t(num_groups) * 5);
  static const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
  for (int g = 0; g < num_groups; g++) {
    for (int k = 0; k < 5; k++) {
      if (!read_huffman(br, kAlphabet[k] + (k == 0 ? cache_size : 0), codes[size_t(g) * 5 + size_t(k)])) {
        return false;
      }
    }
  }
  std::vector<uint32_t> cache(size_t(cache_size), 0);
  const uint32_t cache_shift = 32 - uint32_t(cache_bits);
  out.assign(size_t(xsize) * ysize, 0);
  const size_t total = out.size();
  size_t pos = 0, last_cached = 0;
  auto insert_cache = [&]() {
    if (!cache_size) return;
    while (last_cached < pos) {
      const uint32_t argb = out[last_cached++];
      cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
    }
  };
  while (pos < total) {
    const int x = int(pos % size_t(xsize)), y = int(pos / size_t(xsize));
    const int group = huffman_bits ? int(huffman_image[size_t(y >> huffman_bits) * huffman_xsize +
                                                       size_t(x >> huffman_bits)])
                                   : 0;
    const Huffman* h = &codes[size_t(group) * 5];
    const int code = h[0].read(br);
    if (code < 256) {
      const uint32_t red = uint32_t(h[1].read(br)), blue = uint32_t(h[2].read(br)),
                     alpha = uint32_t(h[3].read(br));
      out[pos++] = (alpha << 24) | (red << 16) | (uint32_t(code) << 8) | blue;
    } else if (code < 256 + 24) {
      const int length = prefix_value(code - 256, br);
      const int dist_symbol = h[4].read(br);
      const int dist_code = prefix_value(dist_symbol, br);
      int dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        const int plane = kCodeToPlane[dist_code - 1];
        const int yoffset = plane >> 4, xoffset = 8 - (plane & 0xf);
        dist = yoffset * xsize + xoffset;
        if (dist < 1) dist = 1;
      }
      if (br.eos) return false;
      if (size_t(dist) > pos || total - pos < size_t(length)) return false;
      for (int k = 0; k < length; k++, pos++) out[pos] = out[pos - size_t(dist)];
    } else {
      const int key = code - 256 - 24;
      if (key >= cache_size) return false;
      insert_cache();
      out[pos++] = cache[size_t(key)];
    }
    insert_cache();
    if (br.eos) return false;
  }
  return true;
}

bool decode_image_stream(BitReader& br, int xsize, int ysize, bool level0, std::vector<uint32_t>& out,
                         std::vector<Transform>* transforms) {
  int width = xsize;
  if (level0) {
    int seen = 0;
    while (br.read(1)) {
      Transform t;
      t.type = int(br.read(2));
      if (seen & (1 << t.type)) return false;
      seen |= 1 << t.type;
      t.xsize = width;
      t.ysize = ysize;
      if (t.type == 0 || t.type == 1) {
        t.bits = int(br.read(3)) + 2;
        if (!decode_image_stream(br, sub_size(width, t.bits), sub_size(ysize, t.bits), false, t.data, nullptr)) {
          return false;
        }
      } else if (t.type == 3) {
        const int num_colors = int(br.read(8)) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        std::vector<uint32_t> palette;
        if (!decode_image_stream(br, num_colors, 1, false, palette, nullptr)) return false;
        const int final_colors = 1 << (8 >> t.bits);
        t.data.assign(size_t(final_colors), 0);
        t.data[0] = palette[0];
        for (int i = 1; i < num_colors && i < final_colors; i++) t.data[size_t(i)] = add_pixels(palette[size_t(i)],
                                                                                                 t.data[size_t(i - 1)]);
        width = sub_size(width, t.bits);
      }
      transforms->push_back(std::move(t));
    }
  }
  return decode_pixels(br, width, ysize, level0, out);
}

inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }

inline uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = int((t >> s) & 0xff), b = int((l >> s) & 0xff), c = int((tl >> s) & 0xff);
    pa_minus_pb += std::abs(b - c) - std::abs(a - c);
  }
  return pa_minus_pb <= 0 ? t : l;
}

inline uint32_t clamped_add_subtract_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = clip255(int((a >> s) & 0xff) + int((b >> s) & 0xff) - int((c >> s) & 0xff));
    out |= uint32_t(v) << s;
  }
  return out;
}

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = int((ave >> s) & 0xff), b = int((c2 >> s) & 0xff);
    out |= uint32_t(clip255(a + (a - b) / 2)) << s;
  }
  return out;
}

uint32_t predict(int mode, const uint32_t* px, int width) {
  // px: the current pixel in a row-major image; its left, top, top-left and top-right
  const uint32_t L = px[-1], T = px[-width], TL = px[-width - 1], TR = px[-width + 1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamped_add_subtract_full(L, T, TL);
    case 13: return clamped_add_subtract_half(L, T, TL);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

void inverse_transform(const Transform& t, std::vector<uint32_t>& px) {
  const int w = t.xsize, h = t.ysize;
  if (t.type == 2) {  // subtract green
    for (uint32_t& p : px) {
      const uint32_t g = (p >> 8) & 0xff;
      const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
      p = (p & 0xff00ff00u) | rb;
    }
  } else if (t.type == 0) {  // predictor
    const int tiles = sub_size(w, t.bits);
    uint32_t* d = px.data();
    d[0] = add_pixels(d[0], 0xff000000u);
    for (int x = 1; x < w; x++) d[x] = add_pixels(d[x], d[x - 1]);
    for (int y = 1; y < h; y++) {
      uint32_t* row = d + size_t(y) * w;
      row[0] = add_pixels(row[0], row[-w]);
      for (int x = 1; x < w; x++) {
        const int mode = int((t.data[size_t(y >> t.bits) * tiles + size_t(x >> t.bits)] >> 8) & 0xf);
        row[x] = add_pixels(row[x], predict(mode, row + x, w));
      }
    }
  } else if (t.type == 1) {  // cross colour
    const int tiles = sub_size(w, t.bits);
    for (int y = 0; y < h; y++) {
      for (int x = 0; x < w; x++) {
        const uint32_t m = t.data[size_t(y >> t.bits) * tiles + size_t(x >> t.bits)];
        const int8_t g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff), r2b = int8_t((m >> 16) & 0xff);
        uint32_t& p = px[size_t(y) * w + x];
        const int8_t green = int8_t((p >> 8) & 0xff);
        int new_red = int((p >> 16) & 0xff);
        int new_blue = int(p & 0xff);
        new_red += (int(g2r) * green) >> 5;
        new_red &= 0xff;
        new_blue += (int(g2b) * green) >> 5;
        new_blue += (int(r2b) * int8_t(new_red)) >> 5;
        new_blue &= 0xff;
        p = (p & 0xff00ff00u) | (uint32_t(new_red) << 16) | uint32_t(new_blue);
      }
    }
  } else {  // colour indexing: the packed width back to the full one
    const int packed_w = sub_size(w, t.bits);
    const int bits_per_pixel = 8 >> t.bits;
    const int count_mask = (1 << t.bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    std::vector<uint32_t> full(size_t(w) * h);
    for (int y = 0; y < h; y++) {
      const uint32_t* src = px.data() + size_t(y) * packed_w;
      uint32_t* dst = full.data() + size_t(y) * w;
      uint32_t packed = 0;
      for (int x = 0; x < w; x++) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & bit_mask];
        packed >>= bits_per_pixel;
      }
    }
    px.swap(full);
  }
}

// a whole VP8L image stream (after any header): its ARGB pixels
bool vp8l_stream(BitReader& br, int w, int h, std::vector<uint32_t>& px) {
  std::vector<Transform> transforms;
  if (!decode_image_stream(br, w, h, true, px, &transforms)) return false;
  for (size_t i = transforms.size(); i-- > 0;) inverse_transform(transforms[i], px);
  return px.size() == size_t(w) * h;
}

int vp8l_info(const uint8_t* data, size_t n, int* info) {
  if (n < 5 || data[0] != 0x2f) return CORRUPT;
  BitReader br{data + 1, n - 1};
  info[0] = int(br.read(14)) + 1;
  info[1] = int(br.read(14)) + 1;
  info[2] = int(br.read(1));
  if (br.read(3) != 0) return CORRUPT;
  return OK;
}

int vp8l_decode(const uint8_t* data, size_t n, uint8_t* rgba, int w, int h) {
  int info[3];
  if (vp8l_info(data, n, info) != OK || info[0] != w || info[1] != h) return CORRUPT;
  BitReader br{data, n};
  br.pos = 8 + 14 + 14 + 1 + 3;
  std::vector<uint32_t> px;
  if (!vp8l_stream(br, w, h, px)) return CORRUPT;
  for (size_t i = 0; i < px.size(); i++) {
    const uint32_t p = px[i];
    rgba[4 * i] = uint8_t(p >> 16);
    rgba[4 * i + 1] = uint8_t(p >> 8);
    rgba[4 * i + 2] = uint8_t(p);
    rgba[4 * i + 3] = uint8_t(p >> 24);
  }
  return OK;
}

// -- ALPH -----------------------------------------------------------------------------

int alpha_decode(const uint8_t* data, size_t n, int w, int h, uint8_t* alpha) {
  if (n < 1) return CORRUPT;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3, reserved = data[0] >> 6;
  if (method > 1 || filter > 3 || pre > 1 || reserved) return CORRUPT;
  const size_t count = size_t(w) * h;
  std::vector<uint8_t> raw(count);
  if (method == 0) {
    if (n - 1 < count) return CORRUPT;
    std::memcpy(raw.data(), data + 1, count);
  } else {
    BitReader br{data + 1, n - 1};
    std::vector<uint32_t> px;
    if (!vp8l_stream(br, w, h, px)) return CORRUPT;
    for (size_t i = 0; i < count; i++) raw[i] = uint8_t(px[i] >> 8);
  }
  for (int y = 0; y < h; y++) {
    const uint8_t* in = raw.data() + size_t(y) * w;
    uint8_t* out = alpha + size_t(y) * w;
    const uint8_t* prev = y > 0 ? out - w : nullptr;
    if (filter == 0) {
      std::memcpy(out, in, size_t(w));
    } else if (filter == 1 || prev == nullptr) {  // horizontal (and the first row of each filter)
      uint8_t pred = prev == nullptr ? 0 : prev[0];
      for (int x = 0; x < w; x++) {
        out[x] = uint8_t(pred + in[x]);
        pred = out[x];
      }
    } else if (filter == 2) {  // vertical
      for (int x = 0; x < w; x++) out[x] = uint8_t(prev[x] + in[x]);
    } else {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < w; x++) {
        top = prev[x];
        const int g = left + top - top_left;
        left = uint8_t(in[x] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
        top_left = top;
        out[x] = left;
      }
    }
  }
  return OK;
}

}  // namespace

extern "C" {

// no exception crosses the C interface (an allocation that fails)
int dial_webp_vp8_info(const uint8_t* data, long long n, int* info) {
  if (n < 10) return CORRUPT;
  if (data[0] & 1) return UNSUPPORTED;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return CORRUPT;
  info[0] = ((data[7] << 8) | data[6]) & 0x3fff;
  info[1] = ((data[9] << 8) | data[8]) & 0x3fff;
  return OK;
}

int dial_webp_vp8_decode(const uint8_t* data, long long n, uint8_t* rgba, int width, int height) {
  try {
    return vp8_decode(data, size_t(n), rgba, width, height);
  } catch (...) {
    return CORRUPT;
  }
}

int dial_webp_vp8l_info(const uint8_t* data, long long n, int* info) { return vp8l_info(data, size_t(n), info); }

int dial_webp_vp8l_decode(const uint8_t* data, long long n, uint8_t* rgba, int width, int height) {
  try {
    return vp8l_decode(data, size_t(n), rgba, width, height);
  } catch (...) {
    return CORRUPT;
  }
}

int dial_webp_alpha(const uint8_t* data, long long n, int width, int height, uint8_t* alpha) {
  try {
    return alpha_decode(data, size_t(n), width, height, alpha);
  } catch (...) {
    return CORRUPT;
  }
}

}  // extern "C"
