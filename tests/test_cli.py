"""argv-level CLI resolution tests: defaults < config file < CLI flags
(/root/reference/approx_counter.cpp:700-758 precedence, exact code
defaults :700-715)."""

import pytest

from approx_counter_tpu.config.cli import resolve_params


def test_code_defaults():
    """Code defaults are authoritative (help-text drift, COMPAT #8)."""
    prm = resolve_params(["in.fasta"])
    assert prm.input_file == "in.fasta"
    assert prm.output == "out.txt"
    assert prm.k == 16
    assert prm.sl == 100
    assert prm.sn == 40000        # not the help text's 10000
    assert prm.limit == 500
    assert prm.param_lc == 1.0    # not the help text's 1.5
    assert prm.nb_thread == 4
    assert prm.v == 1
    assert prm.nb_of_runs == 1
    assert prm.solid_km == 0
    assert not prm.skip_end
    assert prm.max_error == 2


def test_config_layer_overrides_defaults(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text(
        "# comment\nk=8\nsn=123\nlc=2.5\nlim=9\nsl=40\nnt=2\nmr=3\nv=2\n"
        "sk=5\nfk=f.txt\ne=e.txt\nse\n"
    )
    prm = resolve_params(["in.fasta", "-conf", str(conf)])
    assert prm.k == 8 and prm.sn == 123 and prm.param_lc == 2.5
    assert prm.limit == 9 and prm.sl == 40 and prm.nb_thread == 2
    assert prm.nb_of_runs == 3 and prm.v == 2 and prm.solid_km == 5
    assert prm.forbid_kmer == "f.txt" and prm.exact_out == "e.txt"
    assert prm.skip_end  # presence of the key alone sets it (:733)


def test_cli_beats_config(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text("k=8\nsn=123\nlim=9\n")
    prm = resolve_params(
        ["in.fasta", "-conf", str(conf), "-k", "12", "-lim", "77"]
    )
    assert prm.k == 12          # CLI wins
    assert prm.limit == 77      # CLI wins
    assert prm.sn == 123        # config survives where no flag given


def test_skip_end_or_merge(tmp_path):
    """-se OR-merges with the config (:758): config-off + CLI-on => on,
    config-on + CLI-off => still on."""
    conf = tmp_path / "c.conf"
    conf.write_text("k=8\n")
    assert resolve_params(["i", "-conf", str(conf), "-se"]).skip_end
    conf.write_text("se\n")
    assert resolve_params(["i", "-conf", str(conf)]).skip_end


def test_extensions_and_errors(capsys):
    prm = resolve_params(["i", "--seed", "7", "--max-error", "1",
                          "--compat-quirks", "--stream"])
    assert prm.seed == 7 and prm.max_error == 1
    assert prm.compat_quirks and prm.stream
    # parse errors exit 1 like the reference (approx_counter.cpp:693-698),
    # not argparse's default 2
    with pytest.raises(SystemExit) as e:
        resolve_params(["i", "--max-error", "9"])
    assert e.value.code == 1
    with pytest.raises(SystemExit) as e:
        resolve_params(["i", "-k", "abc"])  # argparse type error
    assert e.value.code == 1
    with pytest.raises(SystemExit) as e:
        resolve_params([])  # missing positional
    assert e.value.code == 1
    with pytest.raises(SystemExit) as e:
        resolve_params(["i", "--bogus-flag"])  # unknown flag
    assert e.value.code == 1
    with pytest.raises(SystemExit) as e:
        resolve_params(["--help"])  # help stays 0 (reference prints + 0)
    assert e.value.code == 0
    capsys.readouterr()


def test_validate_contract():
    prm = resolve_params(["i", "-k", "40"])
    with pytest.raises(ValueError, match="between 2 and 32"):
        prm.validate()
    prm = resolve_params(["i", "-k", "16", "-sl", "10"])
    with pytest.raises(ValueError, match="k <= sl"):
        prm.validate()


def test_malformed_input_exit_contract(tmp_path, capsys):
    """Malformed input exits 1 with the /!\\ ERROR prefix (COMPAT #19);
    the reference's SeqAn throw escapes main -> terminate, so a clean
    exit-1 is a strict refinement.  Covers: garbage first byte, truncated
    FASTQ record, quality-length mismatch -- in bulk and --stream modes."""
    from approx_counter_tpu.__main__ import main

    # (name, content, raises-in-stream-mode): the streaming parsers
    # (Python and native, matched EOF semantics) deliberately close a
    # truncated-at-EOF record instead of raising (chunk-boundary design,
    # COMPAT #17/#19) -- bulk mode is strict like SeqAn's readRecords.
    cases = [
        ("garbage.txt", "not a fasta at all\njust text\n", True),
        ("trunc.fastq", "@r1\nACGTACGT\n", False),  # no '+', no quality
        ("qmis.fastq", "@r1\nACGTACGT\n+\nII\n@r2\nACGT\n+\nIIII\n", True),
    ]
    for name, content, stream_raises in cases:
        path = tmp_path / name
        path.write_text(content)
        for extra in ([], ["--stream"]):
            rc = main([str(path), "-o", str(tmp_path / "o.txt"),
                       "-k", "4", "-sl", "4", "-sn", "5", "-v", "0"]
                      + extra)
            err = capsys.readouterr().err
            if extra and not stream_raises:
                assert rc == 0, (name, extra, err)
            else:
                assert rc == 1, (name, extra)
                assert "/!\\ ERROR: " in err, (name, extra, err)


def test_internal_valueerror_not_masked(tmp_path, monkeypatch):
    """Only InputFormatError is reclassified as a malformed-input exit;
    an internal ValueError must traceback (COMPAT #19 refinement)."""
    import approx_counter_tpu.__main__ as m

    def boom(prm):
        raise ValueError("internal bug, not bad input")

    fa = tmp_path / "ok.fasta"
    fa.write_text(">r0\nACGTACGT\n")
    monkeypatch.setattr("approx_counter_tpu.pipeline.run_pipeline", boom)
    with pytest.raises(ValueError, match="internal bug"):
        m.main([str(fa), "-o", str(tmp_path / "o.txt"), "-v", "0"])


@pytest.mark.parametrize("flag,want", [([], None), (["--bpm-impl", "jnp"],
                                                    "jnp"),
                                       (["--bpm-impl", "kernel"], "kernel")])
def test_bpm_impl_flag(flag, want):
    prm = resolve_params(["in.fa", *flag])
    assert prm.bpm_impl == want


def test_bpm_impl_flag_rejects_unknown():
    with pytest.raises(SystemExit) as e:
        resolve_params(["in.fa", "--bpm-impl", "pallas"])
    assert e.value.code == 1
