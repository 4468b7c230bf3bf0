"""Program options and command-line parsing.

Mirrors the reference Options object (reference: options.h:21-241,
options.cpp:18-916): same flags, defaults, validation messages and verbose
echo.  The Options instance is the single configuration object consumed by
the engine; in the multi-host runtime it is replicated to every host
(equivalent of the reference's MPI broadcast of Options).
"""

import getopt
import sys

import numpy as np

from tntblast_tpu import constants as C


def f32(x):
    """Round through float32 (reference stores all thresholds as C float)."""
    return float(np.float32(x))


class OptionsError(Exception):
    pass


class Options:
    def __init__(self, argv=None):
        self.default_values()
        if argv is not None:
            self.parse(argv)

    def default_values(self):
        """reference options.h:85-170."""
        self.dbase_filename = ""
        self.local_dbase_filename = ""
        self.output_filename = ""
        self.input_filename = ""
        self.sig_list = []
        self.blast_include = []
        self.blast_exclude = []

        self.max_len = C.DEFAULT_MAX_LEN
        self.primer_clamp = C.DEFAULT_PRIMER_CLAMP
        self.min_max_primer_clamp = C.DEFAULT_MIN_MAX_PRIMER_CLAMP
        self.probe_clamp_5 = C.DEFAULT_PROBE_CLAMP_5
        self.probe_clamp_3 = C.DEFAULT_PROBE_CLAMP_3
        self.max_gap = C.DEFAULT_MAX_GAP
        self.max_mismatch = C.DEFAULT_MAX_MISMATCH
        self.max_poly_degen = C.DEFAULT_MAX_POLY_DEGEN
        self.target_strand = C.SEQ_STRAND_BOTH

        self.min_primer_tm = f32(C.DEFAULT_MIN_PRIMER_TM)
        self.max_primer_tm = f32(C.DEFAULT_MAX_PRIMER_TM)
        self.min_primer_dg = f32(C.DEFAULT_MIN_PRIMER_DG)
        self.max_primer_dg = f32(C.DEFAULT_MAX_PRIMER_DG)
        self.min_probe_tm = f32(C.DEFAULT_MIN_PROBE_TM)
        self.max_probe_tm = f32(C.DEFAULT_MAX_PROBE_TM)
        self.min_probe_dg = f32(C.DEFAULT_MIN_PROBE_DG)
        self.max_probe_dg = f32(C.DEFAULT_MAX_PROBE_DG)

        self.salt = f32(C.DEFAULT_SALT)
        self.primer_strand = f32(C.DEFAULT_PRIMER_STRAND)
        self.probe_strand = f32(C.DEFAULT_PROBE_STRAND)
        self.target_t = f32(C.DEFAULT_TARGET_T)
        self.asymmetric_strand_ratio = 1.0

        self.print_usage = False
        self.output_format = (C.OUTPUT_STANDARD | C.OUTPUT_ALIGNMENTS
                              | C.OUTPUT_SEQ_MATCH)
        self.mask_options = C.NO_MASK
        self.verbose = True
        self.ignore_probe = False
        self.one_output_file_per_query = False
        self.append_name_to_defline = False
        self.assay_summary = False
        self.multiplex = False
        self.dump_query = False
        self.use_dinkelbach = False
        self.allow_dangle_5 = C.DEFAULT_DANGLE_5
        self.allow_dangle_3 = C.DEFAULT_DANGLE_3
        self.degen_rescale_ct = C.DEFAULT_RESCALE_CT
        self.best_match = False
        self.single_primer_pcr = True
        self.query_segmentation = C.QUERY_SEGMENTATION_OFF
        self.assay_format = C.ASSAY_PCR
        self.hash_word_size = C.DEFAULT_HASH_WORD_SIZE
        self.fragment_target_threshold = C.DEFAULT_FRAGMENT_TARGET_LENGTH
        self.threshold_format = C.THRESHOLD_NONE
        # Device extension (not in the reference): batched device DP screening
        # of candidate windows before exact evaluation; --mesh additionally
        # shards fragment batches over every available device
        # (jax.sharding.Mesh — the multi-chip data-parallel runtime)
        self.tpu_screen = False
        self.tpu_frag = False
        self.use_mesh = False

    # ------------------------------------------------------------------
    def parse(self, argv):
        self.parse_command_line(argv)
        if not self.print_usage:
            self.validate_parameters()

    _SHORT = "i:o:d:D:l:e:E:z:Z:x:X:g:G:s:t:T:y:A:W:m:a:M:k:K:r:v:p:n:L:S:h"
    _LONG = [
        "help", "primer-clamp=", "probe-clamp5=", "probe-clamp3=", "plex=",
        "single-primer-pcr=", "hash-size=", "target-strand=", "temperature=",
        "max-target-len=", "query-seg=", "dump-query=", "dangle5=",
        "dangle3=", "min-max-primer-clamp=", "dinkelbach=", "max-gap=",
        "max-mismatch=", "rescale-ct=", "best-match", "blast-include=",
        "blast-exclude=", "max-poly-degen=", "tpu-screen=", "tpu-frag=",
        "mesh=",
    ]

    def parse_command_line(self, argv):
        """reference options.cpp:18-496."""
        self.threshold_format = C.THRESHOLD_NONE
        self.print_usage = len(argv) == 0
        try:
            opts, _ = getopt.gnu_getopt(argv, self._SHORT, self._LONG)
        except getopt.GetoptError as e:
            raise OptionsError(str(e))

        def set_bit(field, bit, value):
            if value:
                setattr(self, field, getattr(self, field) | bit)
            else:
                setattr(self, field, getattr(self, field) & ~bit)

        for flag, arg in opts:
            if flag == "-i":
                self.input_filename = arg
            elif flag == "-o":
                self.output_filename = arg
            elif flag == "-d":
                self.dbase_filename = arg
            elif flag == "-D":
                self.local_dbase_filename = arg
            elif flag == "-l":
                self.max_len = int(arg)
            elif flag == "-e":
                self.min_primer_tm = f32(arg)
                self.threshold_format |= C.THRESHOLD_PRIMER_TM
            elif flag == "-E":
                self.min_probe_tm = f32(arg)
                self.threshold_format |= C.THRESHOLD_PROBE_TM
            elif flag == "-z":
                self.min_primer_dg = f32(arg)
                self.threshold_format |= C.THRESHOLD_PRIMER_DELTA_G
            elif flag == "-Z":
                self.min_probe_dg = f32(arg)
                self.threshold_format |= C.THRESHOLD_PROBE_DELTA_G
            elif flag == "-x":
                self.max_primer_tm = f32(arg)
                self.threshold_format |= C.THRESHOLD_PRIMER_TM
            elif flag == "-X":
                self.max_probe_tm = f32(arg)
                self.threshold_format |= C.THRESHOLD_PROBE_TM
            elif flag == "-g":
                self.max_primer_dg = f32(arg)
                self.threshold_format |= C.THRESHOLD_PRIMER_DELTA_G
            elif flag == "-G":
                self.max_probe_dg = f32(arg)
                self.threshold_format |= C.THRESHOLD_PROBE_DELTA_G
            elif flag == "-s":
                self.salt = f32(arg)
            elif flag == "-t":
                self.primer_strand = f32(arg)
            elif flag == "-T":
                self.probe_strand = f32(arg)
            elif flag == "-y":
                self.asymmetric_strand_ratio = f32(arg)
            elif flag == "-A":
                self.assay_format = self.parse_assay_format(arg)
            elif flag == "-W":
                self.hash_word_size = int(arg)
            elif flag == "-m":
                self.parse_output_file(arg)
            elif flag == "-a":
                set_bit("output_format", C.OUTPUT_ALIGNMENTS,
                        self.parse_bool(arg))
            elif flag == "-M":
                set_bit("output_format", C.OUTPUT_SEQ_MATCH,
                        self.parse_bool(arg))
            elif flag == "-k":
                set_bit("mask_options", C.MASK_PRIMERS, self.parse_bool(arg))
            elif flag == "-K":
                set_bit("mask_options", C.MASK_PROBE, self.parse_bool(arg))
            elif flag == "-r":
                set_bit("mask_options", C.REPLACE_PRIMERS,
                        self.parse_bool(arg))
            elif flag == "-v":
                self.verbose = self.parse_bool(arg)
            elif flag == "-p":
                self.ignore_probe = self.parse_bool(arg)
            elif flag == "-n":
                self.one_output_file_per_query = self.parse_bool(arg)
            elif flag == "-L":
                self.append_name_to_defline = self.parse_bool(arg)
            elif flag == "-S":
                self.assay_summary = self.parse_bool(arg)
            elif flag in ("-h", "-?", "--help"):
                self.print_usage = True
            elif flag == "--primer-clamp":
                self.primer_clamp = int(arg)
            elif flag == "--probe-clamp5":
                self.probe_clamp_5 = int(arg)
            elif flag == "--probe-clamp3":
                self.probe_clamp_3 = int(arg)
            elif flag == "--plex":
                self.multiplex = self.parse_bool(arg)
            elif flag == "--single-primer-pcr":
                self.single_primer_pcr = self.parse_bool(arg)
            elif flag == "--target-strand":
                self.target_strand = self.parse_strand(arg)
            elif flag == "--temperature":
                self.target_t = f32(arg)
                if self.target_t < 0.0:
                    print("Warning: --temperature is less than zero!",
                          file=sys.stderr)
            elif flag == "--max-target-len":
                self.fragment_target_threshold = int(arg)
                if self.fragment_target_threshold <= 1:
                    raise OptionsError("Error: --max-target-len is <= 1")
            elif flag == "--query-seg":
                self.query_segmentation = self.parse_query_seg(arg)
            elif flag == "--dump-query":
                self.dump_query = self.parse_bool(arg)
            elif flag == "--dangle5":
                self.allow_dangle_5 = self.parse_bool(arg)
            elif flag == "--dangle3":
                self.allow_dangle_3 = self.parse_bool(arg)
            elif flag == "--min-max-primer-clamp":
                self.min_max_primer_clamp = int(arg)
            elif flag == "--dinkelbach":
                self.use_dinkelbach = self.parse_bool(arg)
            elif flag == "--max-gap":
                self.max_gap = int(arg)
            elif flag == "--max-mismatch":
                self.max_mismatch = int(arg)
            elif flag == "--rescale-ct":
                self.degen_rescale_ct = self.parse_bool(arg)
            elif flag == "--best-match":
                self.best_match = True
            elif flag == "--blast-include":
                self.blast_include.append(arg)
            elif flag == "--blast-exclude":
                self.blast_exclude.append(arg)
            elif flag == "--max-poly-degen":
                self.max_poly_degen = abs(int(arg))
            elif flag == "--tpu-screen":
                self.tpu_screen = self.parse_bool_auto(arg)
            elif flag == "--tpu-frag":
                self.tpu_frag = self.parse_bool_auto(arg)
            elif flag == "--mesh":
                self.use_mesh = self.parse_bool(arg)

    @staticmethod
    def parse_assay_format(opt):
        opt = opt.upper()
        return {
            "PCR": C.ASSAY_PCR, "PROBE": C.ASSAY_PROBE,
            "PADLOCK": C.ASSAY_PADLOCK, "MIPS": C.ASSAY_MIPS,
            "MIP": C.ASSAY_MIPS, "AFFYMETRIX": C.ASSAY_AFFYMETRIX,
            "AFFY": C.ASSAY_AFFYMETRIX,
        }.get(opt, C.ASSAY_NONE)

    def parse_output_file(self, fmt):
        opt = int(fmt)
        self.output_format &= ~(C.OUTPUT_STANDARD | C.OUTPUT_FASTA
                                | C.OUTPUT_NETWORK | C.OUTPUT_INVERSE_TARGET
                                | C.OUTPUT_INVERSE_QUERY)
        bits = [C.OUTPUT_STANDARD, C.OUTPUT_FASTA, C.OUTPUT_NETWORK,
                C.OUTPUT_INVERSE_TARGET, C.OUTPUT_INVERSE_QUERY]
        if not (0 <= opt < len(bits)):
            raise OptionsError(
                "Unknown output format. Please specify a number between 0-3")
        self.output_format |= bits[opt]

    @staticmethod
    def parse_bool(opt):
        opt = opt.upper()
        if opt in ("T", "TRUE"):
            return True
        if opt in ("F", "FALSE"):
            return False
        raise OptionsError(
            'Unknown boolean options -- please use "T" or "F"')

    @staticmethod
    def parse_bool_auto(opt):
        """T | F | A(uto): auto runs the device path when JAX's default
        backend is a GPU and the host path otherwise
        (engine.select_device_path)."""
        up = opt.upper()
        if up in ("A", "AUTO"):
            return "auto"
        return Options.parse_bool(opt)

    @staticmethod
    def parse_strand(opt):
        opt = opt.upper()
        if opt in ("PLUS", "+", "SENSE"):
            return C.SEQ_STRAND_PLUS
        if opt in ("MINUS", "-", "ANTISENSE"):
            return C.SEQ_STRAND_MINUS
        if opt == "BOTH":
            return C.SEQ_STRAND_BOTH
        raise OptionsError("Unknown target-strand option")

    @staticmethod
    def parse_query_seg(opt):
        opt = opt.upper()
        if opt == "ALWAYS":
            return C.QUERY_SEGMENTATION_ON
        if opt == "NEVER":
            return C.QUERY_SEGMENTATION_OFF
        if opt == "ADAPTIVE":
            return C.QUERY_SEGMENTATION_ADAPTIVE
        raise OptionsError("Unknown query segmentation option")

    # ------------------------------------------------------------------
    def has_probe(self):
        return self.assay_format in (C.ASSAY_PROBE, C.ASSAY_PCR,
                                     C.ASSAY_AFFYMETRIX)

    def has_primers(self):
        return self.assay_format in (C.ASSAY_PCR, C.ASSAY_PADLOCK)

    def validate_parameters(self):
        """reference options.cpp:529-675."""
        if not self.dbase_filename and not self.local_dbase_filename:
            raise OptionsError("Unable to read either dbase or local_dbase")
        if self.dbase_filename and self.local_dbase_filename:
            raise OptionsError(
                "Please specify either dbase or local_dbase (but not both)")
        if self.ignore_probe:
            if self.assay_format != C.ASSAY_PCR:
                raise OptionsError(
                    "Error: Ignore probes (i.e. -p T) can only be used with "
                    "a PCR-based assay format")
            if self.verbose:
                print("** Ignoring all probe sequences **")
        if self.salt <= 0.0:
            raise OptionsError('[Na+] (i.e. "salt") is less than zero')
        if self.salt >= 1.0:
            raise OptionsError('[Na+] (i.e. "salt") is greater than 1M')
        if self.primer_strand <= 0.0:
            raise OptionsError('[Ct] (i.e. "primer_strand") is less than zero')
        if self.primer_strand > 10.0:
            raise OptionsError(
                '[Ct] (i.e. "primer_strand") is greater than 10M')
        if self.probe_strand < 0.0:
            if self.verbose:
                print("Setting probe strand concentration equal to primer "
                      "strand concentration")
            self.probe_strand = self.primer_strand
        if self.probe_strand <= 0.0:
            raise OptionsError('[Ct] (i.e. "probe_strand") is less than zero')
        if self.probe_strand > 10.0:
            raise OptionsError(
                '[Ct] (i.e. "probe_strand") is greater than 10M')
        if self.asymmetric_strand_ratio <= 0.0:
            raise OptionsError(
                "The ratio of forward to reverse primer [Ct] is <= 0")
        if self.min_primer_tm < 0.0:
            raise OptionsError("min_primer_tm is less than zero")
        if self.min_primer_tm > 200.0:
            raise OptionsError(
                "min_primer_tm is greater than 200 C -- that's too hot!")
        if self.max_primer_tm < 0.0:
            raise OptionsError("max_primer_tm is less than zero")
        if self.min_primer_tm > self.max_primer_tm:
            raise OptionsError(
                "min_primer_tm > max_primer_tm. Please use consistent values!")
        if self.min_probe_tm < 0.0:
            raise OptionsError("min_probe_tm is less than zero")
        if self.min_probe_tm > 200.0:
            raise OptionsError(
                "min_probe_tm is greater than 200 C -- that's too hot!")
        if self.max_probe_tm < 0.0:
            raise OptionsError("max_probe_tm is less than zero")
        if self.min_probe_tm > self.max_probe_tm:
            raise OptionsError(
                "min_probe_tm > max_probe_tm. Please use consistent values!")
        if self.max_len <= 0:
            raise OptionsError("max_len is less than 1 base -- too small!")
        if self.primer_clamp < 0:
            raise OptionsError("primer_clamp is less than 0 -- too small!")
        if self.probe_clamp_5 < 0:
            raise OptionsError("probe_clamp_5 is less than 0 -- too small!")
        if self.probe_clamp_3 < 0:
            raise OptionsError("probe_clamp_3 is less than 0 -- too small!")
        if self.assay_format == C.ASSAY_NONE:
            raise OptionsError("Please specify a valid assay format")
        if not (3 <= self.hash_word_size <= 8):
            raise OptionsError("Please specify a valid hash word size")
        if (self.output_format & C.OUTPUT_NETWORK) and not self.output_filename:
            raise OptionsError(
                "Please specify an output filename when writing network files")
        if self.max_gap < 0:
            raise OptionsError("Error: --max-gap < 0")
        if self.max_mismatch < 0:
            raise OptionsError("Error: --max-mismatch < 0")
        if self.verbose:
            msg = {
                C.QUERY_SEGMENTATION_ON: "Query segmentation: always on",
                C.QUERY_SEGMENTATION_OFF: "Query segmentation: disabled",
                C.QUERY_SEGMENTATION_ADAPTIVE: "Query segmentation: adaptive",
            }.get(self.query_segmentation)
            if msg is None:
                raise OptionsError("Unknown option for query segmentation")
            print(msg)

    def validate_search_threshold(self):
        """reference options.cpp:833-916."""
        tf = self.threshold_format
        have_primer_thresh = bool(tf & (C.THRESHOLD_PRIMER_DELTA_G
                                        | C.THRESHOLD_PRIMER_TM))
        have_probe_thresh = bool(tf & (C.THRESHOLD_PROBE_DELTA_G
                                       | C.THRESHOLD_PROBE_TM))
        if self.assay_format == C.ASSAY_PCR:
            for sig in self.sig_list:
                if sig.has_primers() and not have_primer_thresh:
                    raise OptionsError(
                        "Please specify primer search bounds in Tm and/or "
                        "Delta G")
                if sig.has_probe() and not have_probe_thresh:
                    raise OptionsError(
                        "Please specify probe search bounds in Tm and/or "
                        "Delta G")
        elif self.assay_format in (C.ASSAY_PROBE, C.ASSAY_AFFYMETRIX,
                                   C.ASSAY_PADLOCK, C.ASSAY_MIPS):
            if not have_probe_thresh:
                if have_primer_thresh:
                    self.min_probe_dg = self.min_primer_dg
                    self.max_probe_dg = self.max_primer_dg
                    self.min_probe_tm = self.min_primer_tm
                    self.max_probe_tm = self.max_primer_tm
                else:
                    raise OptionsError(
                        "Please specify probe search bounds in Tm and/or "
                        "Delta G")
        elif self.assay_format == C.ASSAY_NONE:
            raise OptionsError("No assay format has been specified!")

    def max_product_length(self):
        """reference options.cpp:790-831."""
        ret = 0
        if self.assay_format == C.ASSAY_PCR:
            for sig in self.sig_list:
                if sig.has_primers():
                    return self.max_len
                ret = max(ret, len(sig.probe_oligo or ""))
            return ret
        if self.assay_format == C.ASSAY_PADLOCK:
            for sig in self.sig_list:
                ret = max(ret, len(sig.forward_oligo or "")
                          + len(sig.reverse_oligo or ""))
            return ret
        for sig in self.sig_list:
            ret = max(ret, len(sig.probe_oligo or ""))
        return ret

    def write_queries(self, stream):
        """reference options.cpp:918-941."""
        for sig in self.sig_list:
            line = sig.name
            if sig.has_primers():
                line += "\t" + sig.forward_oligo + "\t" + sig.reverse_oligo
            if sig.has_probe():
                line += "\t" + sig.probe_oligo
            print(line, file=stream)

    # Derived concentrations (reference tntblast_local.cpp:232-234)
    @property
    def forward_primer_strand(self):
        return f32(np.float32(self.asymmetric_strand_ratio)
                   * np.float32(self.primer_strand))

    @property
    def reverse_primer_strand(self):
        return self.primer_strand
