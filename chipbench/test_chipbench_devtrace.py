"""The trace's pure arithmetic on the CPU: kernel names shortened for the
breakdown, and idle gaps labelled by the innermost host span."""
import pytest

from chipbench.harness.devtrace import idle_by_span, short_name


@pytest.mark.parametrize("name,short", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<int, int, int, "
     "at::native::BitwiseXorFunctor<int> >, std::array<char*, 3ul> >(int, at::native::BinaryFunctor<int, int, int, "
     "at::native::BitwiseXorFunctor<int> >, std::array<char*, 3ul>)",
     "at::native::vectorized_elementwise_kernel[BitwiseXorFunctor]"),
    ("(anonymous namespace)::threefry_bits_kernel((anonymous namespace)::HostKeys, unsigned int const*, long)",
     "threefry_bits_kernel"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy"),
])
def test_short_name(name, short):
    assert short_name(name) == short


def test_idle_gaps_go_to_the_innermost_span():
    s = 10**9
    spans = [("execute", 0, 10 * s), ("node[Join]", 1 * s, 5 * s), ("node[Sort]", 6 * s, 9 * s),
             ("bench.reveal", 11 * s, 12 * s)]
    gaps = [(2 * s, 3 * s), (5 * s + s // 4, 5 * s + 3 * s // 4), (7 * s, 8 * s), (11 * s, 11 * s + s // 2),
            (13 * s, 14 * s)]
    got = idle_by_span(gaps, spans)
    assert got == {"node[Join]": 1.0, "execute": 0.5, "node[Sort]": 1.0, "bench.reveal": 0.5, "outside spans": 1.0}
