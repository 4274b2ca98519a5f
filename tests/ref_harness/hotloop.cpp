// Sample hot-loop harness: a line-faithful transcription of the upstream
// simulator's sequential NCO sample loop (src/galileo-sdr.cpp:481-539;
// double NCO accumulation, 512-entry integer trig LUT, integer channel
// accumulation, C (short) truncation).  The loop is inline in the
// upstream galileo_task and cannot be linked, so it is transcribed
// statement for statement below; every line cites its source.  The
// tables it reads arrive on stdin as raw data, exactly as the repository
// extracted them from the upstream headers
// (galileo_sdr_sim_tpu/data/e1_codes.npz): the amplitude-250 sin/cos
// LUTs, the CS25_1 secondary code bits and the 4092 primary-code bits
// per PRN.  The chip mapping and the BOC(1,1) expansion are transcribed
// here from upstream's codegen (src/gal-sig.cpp), independently of the
// package's own `codes.boc_chips`, so the fixture also witnesses that
// expansion.  tools/gen_hotloop_fixture.py builds and drives it to
// produce tests/data/hotloop_ref_iq.npz.  Build:
//   g++ -O1 -o hotloop tests/ref_harness/hotloop.cpp
//
// Protocol (stdin, one command per line):
//   tables <512 cos> <512 sin> <25 secondary bits>
//   chan <slot> <prn> <f_carr> <f_code> <code_phase> <carr_phase> <ibit>
//        <500-char page bits> <4092-char E1B primary-code bits, '0'/'1'>
//        <4092-char E1C primary-code bits>       configure a channel
//   hotrun <nsamp> <delt>            -> "hot <nsamp> " + hex int16 I/Q

#include <cstdio>
#include <iostream>
#include <sstream>
#include <string>

static const int MAX_CHAN = 16;         // constants.h
static const double CA_SEQ_LEN_E1 = 4092;
static const int N_SYM_PAGE = 500;
static const int BOC_LEN = 8184;

static int cosTable512[512];
static int sinTable512[512];
static int GALILEO_E1_SECONDARY_CODE[25];

struct HotChan {
    int prn = 0;
    double f_carr = 0, f_code = 0, code_phase = 0, carr_phase = 0;
    int ibit = 0;
    short ca_E1B[BOC_LEN];
    short ca_E1C[BOC_LEN];
    int page[N_SYM_PAGE];
};
static HotChan hot[MAX_CHAN];

// Page regeneration (:503-506, generateINavMsg on the 500-symbol
// rollover) is replaced by wrapping ibit back into the same provided
// page; fixture scenes are kept shorter than a page so the branch never
// fires, and a wrap is flagged on stderr.
static void run_hot_loop(long nsamp, double delt) {
    printf("hot %ld ", nsamp);
    for (long isamp = 0; isamp < nsamp; isamp++) {       // :481
        int i_acc = 0;                                   // :483
        int q_acc = 0;                                   // :484
        for (int i = 0; i < MAX_CHAN; i++) {             // :487
            if (hot[i].prn > 0) {                        // :489
                if (hot[i].code_phase >= CA_SEQ_LEN_E1) {        // :491
                    hot[i].code_phase -= CA_SEQ_LEN_E1;          // :493
                    hot[i].ibit++;                               // :494
                    if (hot[i].ibit >= N_SYM_PAGE) {             // :497
                        hot[i].ibit = 0;                         // :499
                        fprintf(stderr, "hotrun: page wrapped on chan %d\n", i);
                    }
                }
                int cosPh = cosTable512[((int)(511 * hot[i].carr_phase)) & 511]; // :510
                int sinPh = sinTable512[((int)(511 * hot[i].carr_phase)) & 511]; // :511
                int icode = (int)(hot[i].code_phase * 2);                        // :513
                int E1B_chip = hot[i].ca_E1B[icode];                             // :515
                int E1C_chip = hot[i].ca_E1C[icode];                             // :516
                int databit = hot[i].page[hot[i].ibit] > 0 ? -1 : 1;             // :518
                int secCode = GALILEO_E1_SECONDARY_CODE[hot[i].ibit % 25] > 0 ? -1 : 1; // :519
                int ip = (E1B_chip * databit - E1C_chip * secCode) * cosPh;      // :521
                int qp = (E1B_chip * databit - E1C_chip * secCode) * sinPh;      // :522
                i_acc += ip;                                                     // :525
                q_acc += qp;                                                     // :526
                hot[i].code_phase += hot[i].f_code * delt;                       // :529
                hot[i].carr_phase += hot[i].f_carr * delt;                       // :532
                hot[i].carr_phase -= (long)hot[i].carr_phase;                    // :533
            }
        }
        short is = (short)i_acc;                         // :537
        short qs = (short)q_acc;                         // :538
        printf("%04x%04x", (unsigned short)is, (unsigned short)qs);
    }
    putchar('\n');
}

// codegen_E1B / codegen_E1C (gal-sig.cpp:219-233): hex bit 0 -> +1 and
// bit 1 -> -1 (hex_to_binary_converter, :25-186), then sboc (:198-213)
// turns chip c into the half-chip pair (-c, +c).
static bool read_chips(std::istringstream &ss, short *dst) {
    std::string s;
    ss >> s;
    if ((int)s.size() != BOC_LEN / 2) return false;
    for (int i = 0; i < BOC_LEN / 2; i++) {
        if (s[i] != '0' && s[i] != '1') return false;
        short c = s[i] == '0' ? 1 : -1;
        dst[2 * i] = -c;
        dst[2 * i + 1] = c;
    }
    return true;
}

int main() {
    std::string line;
    while (std::getline(std::cin, line)) {
        std::istringstream ss(line);
        std::string key;
        ss >> key;
        if (key.empty() || key[0] == '#') continue;
        if (key == "tables") {
            for (int i = 0; i < 512; i++) ss >> cosTable512[i];
            for (int i = 0; i < 512; i++) ss >> sinTable512[i];
            for (int i = 0; i < 25; i++) ss >> GALILEO_E1_SECONDARY_CODE[i];
        } else if (key == "chan") {
            int slot; ss >> slot;
            HotChan &h = hot[slot];
            std::string bits;
            ss >> h.prn >> h.f_carr >> h.f_code >> h.code_phase
               >> h.carr_phase >> h.ibit >> bits;
            if ((int)bits.size() != N_SYM_PAGE) {
                fprintf(stderr, "chan: bad page length %zu\n", bits.size());
                return 2;
            }
            for (int i = 0; i < N_SYM_PAGE; i++) h.page[i] = bits[i] - '0';
            if (!read_chips(ss, h.ca_E1B) || !read_chips(ss, h.ca_E1C)) {
                fprintf(stderr, "chan: bad code length\n");
                return 2;
            }
        } else if (key == "hotrun") {
            long nsamp; double delt;
            ss >> nsamp >> delt;
            run_hot_loop(nsamp, delt);
        } else {
            fprintf(stderr, "unknown key: %s\n", key.c_str());
            return 2;
        }
    }
    return 0;
}
