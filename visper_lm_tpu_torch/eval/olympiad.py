"""OlympiadBench native scorer + task configs (en / cn) (a copy of
visper_lm_tpu/eval/olympiad.py, its imports pointed at the port).

Port of the reference fork's rule-based math-answer judge
(the reference's lmms-eval/lmms_eval/tasks/olympiadbench/
olympiadbench_evals.py + en_utils.py/cn_utils.py): \\boxed{...} extraction,
special-symbol normalization, comma splitting outside brackets, \\pm
expansion, then pairwise equivalence through four gates — exact string,
interval, numerical (with the x100/÷100 percentage convention and per-item
precision), symbolic expression, equation ratio.

The fork's expression gates call sympy.parsing.latex.parse_latex, which
needs the antlr4 runtime — NOT available in this environment, so the fork
itself silently degrades there (its try/except returns False). This port
substitutes a LaTeX-lite translator (`latex_to_sympy`) covering the answer
grammar the benchmark actually emits (fractions, roots, powers, pi, basic
functions), so symbolic equivalence WORKS here; everything before the
parser is semantics-identical and parity-pinned in
tests/test_fork_tail_tasks.py on the paths the fork can execute.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Sequence

import sympy as sp

from visper_lm_tpu_torch.data.mm_utils import to_rgb_array
from visper_lm_tpu_torch.eval.harness import TaskConfig

_PI = sp.Symbol("pi")


def latex_to_sympy(expr: str):
    """LaTeX-lite -> sympy: the subset OlympiadBench final answers use.
    Raises on anything it can't translate (callers treat that as 'gate
    failed', exactly like the fork's except-clauses around parse_latex)."""
    s = expr.strip()
    # \frac{a}{b} (+ \dfrac/\tfrac) and \sqrt[n]{x}/\sqrt{x}: the brace-free
    # innermost instances rewrite first; iterating both to a joint fixpoint
    # peels arbitrary nesting (\frac{\sqrt{2}}{2}, \sqrt{\frac{1}{2}}, ...)
    frac = re.compile(r"\\[dt]?frac\s*\{([^{}]*)\}\s*\{([^{}]*)\}")
    sqrtn = re.compile(r"\\sqrt\s*\[([^\[\]]*)\]\s*\{([^{}]*)\}")
    sqrt1 = re.compile(r"\\sqrt\s*\{([^{}]*)\}")
    while True:
        s2 = frac.sub(r"((\1)/(\2))", s)
        s2 = sqrtn.sub(r"((\2)**(1/(\1)))", s2)
        s2 = sqrt1.sub(r"sqrt(\1)", s2)
        if s2 == s:
            break
        s = s2
    s = re.sub(r"\\[dt]?frac\s*(\d)\s*(\d)", r"((\1)/(\2))", s)
    s = re.sub(r"\\sqrt\s*(\d)", r"sqrt(\1)", s)
    # functions and constants
    for name in ("sin", "cos", "tan", "cot", "sec", "csc", "ln", "log",
                 "exp", "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh"):
        s = s.replace("\\" + name, name)
    s = s.replace("\\pi", "pi").replace("π", "pi")
    s = s.replace("\\infty", "oo")
    s = s.replace("\\cdot", "*").replace("\\times", "*").replace("\\div", "/")
    s = s.replace("^", "**")
    # exponent braces: **{...} -> **(...), then any remaining braces group
    s = re.sub(r"\*\*\s*\{([^{}]*)\}", r"**(\1)", s)
    s = s.replace("{", "(").replace("}", ")")
    if "\\" in s:
        raise ValueError(f"untranslated LaTeX in {expr!r}")
    # implicit multiplication: digit before ( or letter, )( etc.
    s = re.sub(r"(\d)\s*\(", r"\1*(", s)
    s = re.sub(r"\)\s*\(", r")*(", s)
    s = re.sub(r"(\d)\s*(pi|sqrt|[a-zA-Z]\b)", r"\1*\2", s)
    s = re.sub(r"\)\s*(pi|sqrt|\d|[a-zA-Z]\b)", r")*\1", s)
    return sp.sympify(s, locals={"pi": _PI}, evaluate=True)


class OlympiadBenchEvaluator:
    """Structure-identical port of olympiadbench_evals.OlympiadBenchEvaluator
    with latex_to_sympy in place of parse_latex."""

    SPECIAL_SIGNAL_MAP = {
        "\\left": "", "\\right": "", "∶": ":", "，": ",", "$": "",
        "\\approx": "=", "\\simeq": "=", "\\sim": "=", "^\\prime": "'",
        "^{\\prime}": "'", "^\\circ": "", "%": "",
    }

    def __init__(self):
        self.pi = _PI
        self.precision = 1e-8

    # --- pieces (evals.py:44-76) ---------------------------------------
    def split_by_comma(self, expr: str) -> List[str]:
        depth, out, start = 0, [], 0
        for i, ch in enumerate(expr):
            if ch in "([":
                depth += 1
            elif ch in ")]":
                depth -= 1
            elif ch == "," and depth == 0:
                out.append(expr[start:i].strip())
                start = i + 1
        if start < len(expr):
            out.append(expr[start:].strip())
        return out

    def trans_plus_minus_sign(self, exprs: List[str]) -> List[str]:
        out = []
        for e in exprs:
            if "\\pm" in e:
                out.append(e.replace("\\pm", "+"))
                out.append(e.replace("\\pm", "-"))
            else:
                out.append(e)
        return out

    # --- judge (evals.py:77-121) ----------------------------------------
    def judge(self, expression1: str, expression2: str,
              precision=1e-8) -> bool:
        precision = precision if isinstance(precision, list) else [precision]
        try:
            expression1, expression2 = self.preprocess(expression1,
                                                       expression2)
        except Exception:
            return False
        if expression1 == expression2:
            return True
        expression1 = re.sub(r"[\u4e00-\u9fff]+", "", expression1)
        expression2 = re.sub(r"[\u4e00-\u9fff]+", "", expression2)
        list1 = self.trans_plus_minus_sign(self.split_by_comma(expression1))
        list2 = self.trans_plus_minus_sign(self.split_by_comma(expression2))
        if len(precision) <= 1:
            precision = precision * len(list1)
        if len(list1) != len(list2):
            return False
        idx = -1
        while list1:
            idx = (idx + 1) % len(list1)
            item1 = list1[idx]
            self.precision = precision[idx]
            for item2 in list2:
                if self.is_equal(item1, item2):
                    list1.remove(item1)
                    list2.remove(item2)
                    precision.remove(self.precision)
                    break
            else:
                return False
        return True

    # --- equality gates (evals.py:123-266) -------------------------------
    def is_interval(self, expr: str) -> bool:
        return expr.startswith(("(", "[")) and expr.endswith((")", "]"))

    def sympy_sub_pi(self, e):
        return e.subs(self.pi, math.pi)

    def is_equal(self, expression1: str, expression2: str) -> bool:
        if expression1 == expression2 and expression1 != "":
            return True
        if self.is_interval(expression1) and self.is_interval(expression2):
            try:
                if self.interval_equal(expression1, expression2):
                    return True
            except Exception:
                return False
        try:
            if self.numerical_equal(expression1, expression2):
                return True
        except Exception:
            pass
        try:
            if (self.expression_equal(expression1, expression2)
                    and not ("=" in expression1 and "=" in expression2)):
                return True
        except Exception:
            pass
        try:
            if self.equation_equal(expression1, expression2):
                return True
        except Exception:
            pass
        return False

    def numerical_equal(self, expression1: str, expression2: str,
                        include_percentage: bool = True) -> bool:
        reference = float(expression1)
        prediction = float(expression2)
        gts = ([reference / 100, reference, reference * 100]
               if include_percentage else [reference])
        return any(abs(g - prediction) <= self.precision * 1.01 for g in gts)

    def expression_equal(self, exp1: str, exp2: str) -> bool:
        def extract(e):
            return e.split("=")[1].strip() if "=" in e else e.strip()

        e1 = sp.sympify(latex_to_sympy(extract(exp1)))
        e2 = sp.sympify(latex_to_sympy(extract(exp2)))
        if e1 == e2:
            return True
        e1, e2 = self.sympy_sub_pi(e1), self.sympy_sub_pi(e2)
        has1, has2 = e1.has(sp.Symbol), e2.has(sp.Symbol)
        if has1 != has2:
            return False
        if not has1 and not has2:
            try:
                if not (self.can_compute_power(e1)
                        and self.can_compute_power(e2)):
                    return False
                return abs(e1.evalf() - e2.evalf()) <= self.precision * 1.01
            except Exception:
                return False
        try:
            return abs(sp.simplify(e1 - e2).evalf()) < 1e-3
        except Exception:
            return False

    def equation_equal(self, expression1: str, expression2: str) -> bool:
        def simplify_eq(eq: str):
            lhs, rhs = eq.split("=")
            return sp.simplify(latex_to_sympy(lhs) - latex_to_sympy(rhs))

        e1, e2 = simplify_eq(expression1), simplify_eq(expression2)
        d1, d2 = sp.simplify(e1 / e2), sp.simplify(e2 / e1)
        return bool((d1.is_Integer and d1 != 0)
                    or (d2.is_Integer and d2 != 0))

    def interval_equal(self, expression1: str, expression2: str) -> bool:
        def compare(i1: str, i2: str) -> bool:
            if i1[0] != i2[0] or i1[-1] != i2[-1]:
                return False
            a = i1.strip("[]()").split(",")
            b = i2.strip("[]()").split(",")
            return all(self.expression_equal(x, y) for x, y in zip(a, b))

        if expression1 == expression2:
            return True
        l1 = expression1.split("\\cup")
        l2 = expression2.split("\\cup")
        return len(l1) == len(l2) and all(
            compare(a, b) for a, b in zip(l1, l2)
        )

    # --- preprocess (evals.py:268-330) ------------------------------------
    def preprocess(self, expression1: str, expression2: str):
        def extract_boxed(latex_str: str) -> str:
            results = ""
            for m in re.finditer(r"\\boxed{", latex_str):
                start = m.end()
                end, stack = start, 1
                while stack > 0 and end < len(latex_str):
                    if latex_str[end] == "{":
                        stack += 1
                    elif latex_str[end] == "}":
                        stack -= 1
                    end += 1
                if stack == 0:
                    results += latex_str[start:end - 1] + ","
                else:
                    raise ValueError("Mismatched braces in LaTeX string.")
            if results == "":
                last = latex_str.strip().split("\n")[-1]
                answers = re.findall(r"\$(.*?)\$", last)
                if answers:
                    for a in answers:
                        results += a + ","
                else:
                    results = latex_str
            return results

        def replace_special(expression: str) -> str:
            if "\\in " in expression:
                expression = expression.split("\\in ")[1]
            for k, v in self.SPECIAL_SIGNAL_MAP.items():
                expression = expression.replace(k, v)
            expression = expression.strip("\n$,.:;^_=+`!@#$%^&*~，。")
            return re.sub(r"\\(?:mathrm|mathbf)\{~?([^}]*)\}", r"\1",
                          expression)

        e1, e2 = extract_boxed(expression1), extract_boxed(expression2)
        return replace_special(e1), replace_special(e2)

    def can_compute_power(self, expr) -> bool:
        if isinstance(expr, sp.Pow):
            base, exp = expr.as_base_exp()
            if base.is_number and exp.is_number:
                return abs(exp.evalf()) <= 1000
            return False
        return True


_EVALUATOR = OlympiadBenchEvaluator()


def olympiadbench_doc_to_text(doc: dict, lang: str = "en") -> str:
    """en_utils.py:21-48 / cn_utils.py equivalents: competition preamble +
    answer-type instruction + the boxed-answer closing request."""
    question = doc["question"]
    subject = doc["subfield"]
    mul_ans = doc.get("is_multiple_answer") or False
    ans_type = doc["answer_type"]
    if ans_type == "Need_human_evaluate":
        ans_type = "proof based"
    if lang == "en":
        pre = f"The following is a question from an International {subject} competition.\n"
        post = (f"The question has multiple answers, each of them should be {ans_type}.\n"
                if mul_ans else
                f"The answer of the question should be {ans_type}.\n")
        post += ("Please calculate the answer according to the given "
                 "requirements and the information provided. Please use LaTeX "
                 "format to represent the variables and formulas used in the "
                 "solution process and results. Please end your solution with ")
        # NOTE: the multi-answer line omits the opening quote in the fork
        # (en_utils.py:43-44) — kept verbatim
        post += ("So the final answer is \\boxed{multiple answers connected with commas}.\n"
                 if mul_ans else '"So the final answer is \\boxed{answer}."\n')
    else:
        pre = f"以下是中国{subject}竞赛中的解答题。\n"
        post = (f"题目有多个答案，答案类型均为{ans_type}。\n" if mul_ans
                else f"答案类型为{ans_type}。\n")
        post += "请根据题目的要求和所提供的信息计算得出答案。解答过程和结果中使用的变量和公式请使用LaTeX格式表示。请在最后以"
        # cn_utils.py:41 uses a fullwidth '⽂' codepoint in 英⽂ — kept verbatim
        post += ('"所以最终答案是\\boxed{用英⽂逗号连接的多个答案}。"\n' if mul_ans
                 else '"所以最终答案是\\boxed{答案}。"\n')
    return pre + question + "\n" + post


def olympiadbench_process_results(doc: dict, results: List[str],
                                  lang: str = "en") -> Dict[str, Any]:
    """en_utils.py:51-66 / cn_utils.py:48-62: proving problems emit a
    submission record; others strip to the text after 'final answer is'
    (cn: '所以最终答案是') and judge against final_answer[0] at the doc's
    error tolerance."""
    precision = doc.get("error") or 0
    prediction = results[0].strip()
    if "TP" in doc.get("source", ""):
        return {"submission": prediction}
    marker = "final answer is" if lang == "en" else "所以最终答案是"
    prediction = prediction.split(marker)[-1]
    prediction = (prediction.replace('"', "").replace("\n", "")
                  .replace(" ", "").strip(".").strip("。"))
    acc = int(_EVALUATOR.judge(prediction, doc["final_answer"][0], precision))
    return {"exact_match": acc}


def olympiadbench_task(docs: Sequence[dict], lang: str = "en") -> TaskConfig:
    """olympiadbench_test_en / _cn (tasks/olympiadbench/*.yaml). docs: the
    lmms-lab/OlympiadBench rows (question, subfield, images, final_answer,
    answer_type, error, source, is_multiple_answer)."""
    return TaskConfig(
        name=f"olympiadbench_test_{lang}",
        docs=list(docs),
        doc_to_visual=lambda d: [to_rgb_array(im) for im in d["images"]],
        doc_to_text=lambda d: olympiadbench_doc_to_text(d, lang),
        process_results=lambda d, r: olympiadbench_process_results(d, r, lang),
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                           "do_sample": False},
        split="test_en" if lang == "en" else "test_cn",
    )
