// Native results.txt -> results.csv converter.
//
// TPU-framework equivalent of the reference's src/results2csv.c (a small C
// CLI that rewrites Python-tuple-formatted measurement lines as numeric CSV
// rows, results2csv.c:48-74).  This is an independent implementation: a
// tolerant tokenizer over tuple lines rather than a fixed fscanf pattern, so
// it accepts BOTH schemas found in the reference's data:
//   * 10-field ('802.16', '1/2', z, 'A', snr, nblocks, nblockerrors, nbits,
//     nbiterrors, niterations)        -- data/results.txt archive
//   * 9-field (no ptype)              -- ldpc_jossy/py/ldpc_awgn.py:110
// Output schema matches results2csv.c:62-72 exactly: standard as 16/11,
// rate as a decimal, ptype as 0 (A) / 1 (B), then the seven integers/floats.
//
// Build:  g++ -O2 -std=c++17 -o results2csv results2csv.cpp
// Usage:  results2csv < results.txt > results.csv
//         results2csv results.txt [results.csv]

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Field {
    bool is_str = false;
    std::string str;   // for quoted fields
    double num = 0.0;  // for numeric fields
};

// Split one "(a, b, ...)" line into fields. Returns false on malformed input.
bool tokenize(const std::string& line, std::vector<Field>& out) {
    out.clear();
    size_t i = 0, n = line.size();
    while (i < n && isspace((unsigned char)line[i])) i++;
    if (i >= n || line[i] != '(') return false;
    i++;
    while (i < n) {
        while (i < n && (isspace((unsigned char)line[i]) || line[i] == ','))
            i++;
        if (i >= n) return false;
        if (line[i] == ')') return !out.empty();
        Field f;
        if (line[i] == '\'' || line[i] == '"') {
            char q = line[i++];
            size_t j = line.find(q, i);
            if (j == std::string::npos) return false;
            f.is_str = true;
            f.str = line.substr(i, j - i);
            i = j + 1;
        } else {
            char* end = nullptr;
            f.num = strtod(line.c_str() + i, &end);
            if (end == line.c_str() + i) return false;
            i = end - line.c_str();
        }
        out.push_back(std::move(f));
    }
    return false;  // no closing paren
}

// '802.16' -> 16, '802.11n' -> 11 (results2csv.c keys CSV on this suffix).
int standard_code(const std::string& s) {
    return (!s.empty() && s.back() == '6') ? 16 : 11;
}

// '1/2' -> 0.5 etc.
bool rate_value(const std::string& s, double* out) {
    size_t slash = s.find('/');
    if (slash == std::string::npos) return false;
    double num = atof(s.substr(0, slash).c_str());
    double den = atof(s.substr(slash + 1).c_str());
    if (den == 0.0) return false;
    *out = num / den;
    return true;
}

// Convert one tuple line; returns false (skip) on anything malformed.
bool convert(const std::string& line, FILE* out) {
    std::vector<Field> f;
    if (!tokenize(line, f)) return false;
    if (f.size() != 9 && f.size() != 10) return false;

    // normalize the 9-field schema to 10 fields with ptype 'A'
    if (f.size() == 9) {
        Field pt;
        pt.is_str = true;
        pt.str = "A";
        f.insert(f.begin() + 3, std::move(pt));
    }
    if (!f[0].is_str || !f[1].is_str || f[2].is_str || !f[3].is_str)
        return false;
    for (int k = 4; k < 10; k++)
        if (f[k].is_str) return false;

    double rate;
    if (!rate_value(f[1].str, &rate)) return false;
    int ptype = (f[3].str == "B") ? 1 : 0;

    fprintf(out, "%d, %g, %d, %d, %g, %d, %d, %d, %d, %d\n",
            standard_code(f[0].str), rate, ptype,
            (int)f[2].num, f[4].num,
            (int)f[5].num, (int)f[6].num, (int)f[7].num,
            (int)f[8].num, (int)f[9].num);
    return true;
}

}  // namespace

int main(int argc, char** argv) {
    FILE* in = stdin;
    FILE* out = stdout;
    if (argc >= 2) {
        in = fopen(argv[1], "r");
        if (!in) { perror(argv[1]); return 1; }
    }
    if (argc >= 3) {
        out = fopen(argv[2], "w");
        if (!out) { perror(argv[2]); return 1; }
    }
    char buf[4096];
    long converted = 0, skipped = 0;
    while (fgets(buf, sizeof buf, in)) {
        if (convert(buf, out)) converted++;
        else if (buf[strspn(buf, " \t\r\n")] != '\0') skipped++;
    }
    if (out != stdout) fclose(out);
    if (in != stdin) fclose(in);
    fprintf(stderr, "results2csv: %ld converted, %ld skipped\n",
            converted, skipped);
    return 0;
}
