"""The port's dispatcher against the JAX package's contract
(tests/test_cli_dispatch.py): help and version exit 0, a mistyped
subcommand gets the close match instead of the table, a name far from
every subcommand gets the whole table, and both exit 1 with the same
stderr as the reference's dispatcher."""

import pytest

from goleft_tpu import cli as jcli
from goleft_tpu_torch import cli


def test_help_and_version_exit_zero(capsys):
    assert cli.main([]) == 0
    assert "depth" in capsys.readouterr().err
    assert cli.main(["--help"]) == 0
    assert cli.main(["--version"]) == 0


def test_unknown_subcommand_suggests_close_match(capsys):
    assert cli.main(["dept"]) == 1
    err = capsys.readouterr().err
    assert "unknown subcommand: dept" in err
    assert "did you mean depth?" in err
    # a suggestion replaces the table dump
    assert "matricize" not in err


def test_unknown_subcommand_far_from_any_prints_table(capsys):
    assert cli.main(["qqzzxy"]) == 1
    err = capsys.readouterr().err
    assert "unknown subcommand: qqzzxy" in err
    # no plausible guess: the full sorted table prints instead
    for name in cli.PROGS:
        assert name in err


def test_serve_is_registered():
    assert "serve" in cli.PROGS
    assert cli.PROGS["serve"][2] is True  # a device command


@pytest.mark.parametrize("prog", ["dept", "qqzzxy", "cohortdept",
                                  "indexcove", "servee", "zzz"])
def test_unknown_subcommand_stderr_is_the_references(capsys, prog):
    """Byte for byte the reference's stderr, but for the table itself:
    each package prints its own ``usage()`` (the port's program name and
    help texts), and the two tables list the same subcommands."""
    assert jcli.main([prog]) == 1
    want = capsys.readouterr()
    assert cli.main([prog]) == 1
    got = capsys.readouterr()
    assert got.out == want.out == ""
    assert got.err.replace(cli.usage(), "<table>") \
        == want.err.replace(jcli.usage(), "<table>")
    assert ("<table>" in got.err.replace(cli.usage(), "<table>")) \
        == (prog in ("qqzzxy", "zzz"))

    def names(table):
        return [ln.split(":")[0].strip() for ln in table.splitlines()[2:]
                if ln and not ln.startswith(" ") and ":" in ln
                and not ln.startswith("global")]

    assert names(cli.usage()) == names(jcli.usage()) == sorted(cli.PROGS)
