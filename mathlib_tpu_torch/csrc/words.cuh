// The word counts a kernel source instantiates, and its launchers' names.
//
// An element of the base field is NW = L / 2 32-bit words: 8 for BN254
// (L = 16), 12 for BLS12-381 and BLS12-377 (L = 24), and 9 for FP256BN on
// the card (L = 18: its p has its top bit set, so [0, 2p) needs 257 bits,
// and R = 2^288 keeps 4p <= R in whole words; ops/field.py base_limbs).
//
// Each source with launchers is compiled twice: as itself for NW = 8 and
// 12, and through its twin <source>_nw9.cu for NW = 9.  The twin is an nvcc
// process of its own beside the others (ops/kernels/build.py), so the third
// instantiation does not lengthen the build's wall.  It defines MLT_NW9,
// and renames the namespace mlt to mlt_nw9 before it includes the source,
// so that no template, kernel or constant of the two objects shares a
// symbol: only the launchers are extern "C".  The twin's launcher of
// `name` is `name_nw9`; the source's own launcher `name` calls it at L = 18
// (MLT_TO_NW9), so a caller sees one launcher a kernel, taking L = 16, 18
// and 24.  A launcher with no twin (the static ladders, the device hash,
// the one-launch check) is plain extern "C", under #ifndef MLT_NW9 in a
// source that has one, and returns -1 at L = 18.
#pragma once

#ifdef MLT_NW9
// MLT_LAUNCHER(name, parameters...) { body }: the launcher's head
#define MLT_LAUNCHER(name, ...) extern "C" int name##_nw9(__VA_ARGS__)
// MLT_TO_NW9(name, arguments...): the source's launcher hands L = 18 on
#define MLT_TO_NW9(name, ...)
#define MLT_WORD_CASES(...)   \
  case 18: {                  \
    constexpr int NW = 9;     \
    __VA_ARGS__;              \
    break;                    \
  }
#else
#define MLT_LAUNCHER(name, ...)              \
  extern "C" int name##_nw9(__VA_ARGS__);    \
  extern "C" int name(__VA_ARGS__)
#define MLT_TO_NW9(name, ...) \
  if (L == 18) return name##_nw9(__VA_ARGS__);
#define MLT_WORD_CASES(...)   \
  case 16: {                  \
    constexpr int NW = 8;     \
    __VA_ARGS__;              \
    break;                    \
  }                           \
  case 24: {                  \
    constexpr int NW = 12;    \
    __VA_ARGS__;              \
    break;                    \
  }
#endif

// switch (L) over this object's word counts, NW bound in the body; a
// launcher returns -1 for any other L
#define MLT_WORDS(L, ...)            \
  switch (L) {                       \
    MLT_WORD_CASES(__VA_ARGS__)      \
    default:                         \
      return -1;                     \
  }
