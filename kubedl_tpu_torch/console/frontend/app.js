// kubedl-tpu console SPA core: API client, hash router, i18n, helpers.
// Pages live in /pages/*.js as ES modules; the route table below maps
// #/name to each page's render(app, params) export.

import { viewLogin } from "./pages/login.js";
import { viewJobs } from "./pages/jobs.js";
import { viewJobDetail } from "./pages/jobdetail.js";
import { viewSubmit } from "./pages/submit.js";
import { viewNotebooks, viewNotebookCreate } from "./pages/notebooks.js";
import { viewWorkspaces, viewWorkspaceCreate } from "./pages/workspaces.js";
import { viewDataSources, viewCodeSources } from "./pages/sources.js";
import { viewCluster } from "./pages/cluster.js";
import { viewAdmin } from "./pages/admin.js";
import { viewJobCreate } from "./pages/jobcreate.js";
import { viewDataSheets } from "./pages/datasheets.js";
import { view403, view404, view500 } from "./pages/errors.js";
import { viewPlayground } from "./pages/playground.js";

// ---------------------------------------------------------------- api client

export async function api(path, opts = {}) {
  const res = await fetch("/api/v1" + path, {
    headers: { "Content-Type": "application/json" }, ...opts });
  if (res.status === 401) {
    if (!location.hash.startsWith("#/login")) location.hash = "#/login";
    throw new Error("auth");
  }
  if (res.status === 403) {
    const err = new Error("forbidden");
    err.status = 403;
    throw err;
  }
  const ctype = res.headers.get("Content-Type") || "";
  const body = ctype.includes("json") ? await res.json() : await res.text();
  if (typeof body === "object" && body.code !== 200)
    throw new Error(body.msg || "request failed");
  return typeof body === "object" ? body.data : body;
}

// ------------------------------------------------------------------- helpers

export const esc = s => String(s ?? "").replace(/[&<>"]/g,
  ch => ({ "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;" }[ch]));

export const statusCell = s =>
  `<span class="status ${esc(s)}">${esc(s)}</span>`;

export function params() {
  return new URLSearchParams(location.hash.split("?")[1] || "");
}

export function navigate(hash) {
  if (location.hash === hash) route();
  else location.hash = hash;
}

// Render tab strip + panels. tabs = [{id, label, render(el)}]
export function tabbed(el, tabs, active) {
  const id = active || tabs[0].id;
  el.innerHTML = `
    <div class="tabs">${tabs.map(t =>
      `<button data-tab="${t.id}" class="${t.id === id ? "active" : ""}">
       ${esc(t.label)}</button>`).join("")}</div>
    <div id="tab-body"></div>`;
  const body = el.querySelector("#tab-body");
  const show = tab => Promise.resolve(tab.render(body)).catch(e => {
    body.innerHTML = `<p class="error">error: ${esc(e.message)}</p>`;
  });
  el.querySelectorAll("[data-tab]").forEach(btn => btn.onclick = () => {
    el.querySelectorAll("[data-tab]").forEach(b =>
      b.classList.toggle("active", b === btn));
    show(tabs.find(t => t.id === btn.dataset.tab));
  });
  show(tabs.find(t => t.id === id));
}

// ---------------------------------------------------------------------- i18n

const MESSAGES = {
  en: {
    "nav.jobs": "Jobs", "nav.create": "Create", "nav.submit": "Submit",
    "nav.notebooks": "Notebooks", "nav.workspaces": "Workspaces",
    "nav.datasheets": "DataSheets", "nav.datasources": "Data",
    "nav.codesources": "Code", "nav.cluster": "Cluster",
    "nav.logout": "logout",
    "jobs.title": "Training jobs", "jobs.stop": "stop", "jobs.delete": "delete",
    "jobs.archived": "archived", "jobs.allKinds": "all kinds",
    "jobs.allStatuses": "all statuses",
    "detail.pods": "Pods", "detail.events": "Events", "detail.logs": "Logs",
    "detail.manifest": "Manifest", "detail.replicas": "Replicas",
    "detail.autoRefresh": "auto-refreshing while running",
    "submit.title": "Submit job", "submit.form": "Form", "submit.yaml": "YAML",
    "submit.create": "Submit", "submit.preview": "Preview manifest",
    "notebooks.title": "Notebooks", "notebooks.create": "New notebook",
    "workspaces.title": "Workspaces", "workspaces.create": "New workspace",
    "sources.data": "Data sources", "sources.code": "Code sources",
    "sources.add": "Add", "sources.save": "Save", "sources.edit": "edit",
    "cluster.title": "Cluster",
    "nav.playground": "Playground",
    "playground.title": "Inference playground",
    "playground.none": "no Inference objects deployed",
    "playground.target": "Model", "playground.maxTokens": "Max tokens",
    "playground.temperature": "Temperature",
    "playground.placeholder": "Say something\u2026",
    "playground.send": "Send", "playground.clear": "Clear",
    "playground.stop": "Stop",
    "playground.stopSeq": "Stop sequences",
    "playground.stopHint": "comma-separated",
    "nav.admin": "Admin", "admin.title": "Console users",
    "admin.username": "Username", "admin.password": "Password",
    "admin.role": "Role", "admin.add": "Add or update user",
    "login.title": "Sign in", "login.button": "Login",
    "login.failed": "login failed",
    "wizard.title": "Create job", "wizard.basics": "Basics",
    "wizard.replicas": "Replicas", "wizard.tpu": "TPU slice",
    "wizard.review": "Review", "wizard.back": "Back", "wizard.next": "Next",
    "wizard.created": "Job created",
    "wizard.nameRequired": "name is required",
    "wizard.nameInvalid": "name must be lowercase alphanumeric or dashes",
    "wizard.imageRequired": "image is required",
    "wizard.replicasRequired": "at least one replica",
    "wizard.tpuHint": "Pick a slice shape; it is validated against the operator's topology catalog.",
    "wizard.dataSource": "Data source", "wizard.codeSource": "Code source",
    "wizard.elastic": "Elastic", "wizard.elasticHint": "resize in place without losing the slice",
    "sheets.title": "DataSheets", "sheets.use": "use in job",
    "sheets.noData": "no data sources yet", "sheets.noCode": "no code sources yet",
    "errors.backHome": "back to jobs",
    "errors.forbidden": "You do not have permission to view this page.",
    "errors.notFound": "This page does not exist.",
    "errors.serverError": "Something went wrong on the server.",
  },
  zh: {
    "nav.jobs": "任务", "nav.create": "创建", "nav.submit": "提交",
    "nav.notebooks": "笔记本", "nav.workspaces": "工作空间",
    "nav.datasheets": "数据表", "nav.datasources": "数据",
    "nav.codesources": "代码", "nav.cluster": "集群",
    "nav.logout": "退出",
    "jobs.title": "训练任务", "jobs.stop": "停止", "jobs.delete": "删除",
    "jobs.archived": "已归档", "jobs.allKinds": "全部类型",
    "jobs.allStatuses": "全部状态",
    "detail.pods": "容器组", "detail.events": "事件", "detail.logs": "日志",
    "detail.manifest": "清单", "detail.replicas": "副本",
    "detail.autoRefresh": "运行中自动刷新",
    "submit.title": "提交任务", "submit.form": "表单", "submit.yaml": "YAML",
    "submit.create": "提交", "submit.preview": "预览清单",
    "notebooks.title": "笔记本", "notebooks.create": "新建笔记本",
    "workspaces.title": "工作空间", "workspaces.create": "新建工作空间",
    "sources.data": "数据源", "sources.code": "代码源",
    "sources.add": "新增", "sources.save": "保存", "sources.edit": "编辑",
    "cluster.title": "集群",
    "nav.playground": "试用",
    "playground.title": "推理试用",
    "playground.none": "没有已部署的 Inference 对象",
    "playground.target": "模型", "playground.maxTokens": "最大 token 数",
    "playground.temperature": "温度",
    "playground.placeholder": "输入内容\u2026",
    "playground.send": "发送", "playground.clear": "清空",
    "playground.stop": "停止",
    "playground.stopSeq": "停止序列",
    "playground.stopHint": "逗号分隔",
    "nav.admin": "管理", "admin.title": "控制台用户",
    "admin.username": "用户名", "admin.password": "密码",
    "admin.role": "角色", "admin.add": "添加或更新用户",
    "login.title": "登录", "login.button": "登录",
    "login.failed": "登录失败",
    "wizard.title": "创建任务", "wizard.basics": "基础信息",
    "wizard.replicas": "副本", "wizard.tpu": "TPU 切片",
    "wizard.review": "确认", "wizard.back": "上一步", "wizard.next": "下一步",
    "wizard.created": "任务已创建",
    "wizard.nameRequired": "名称必填",
    "wizard.nameInvalid": "名称必须为小写字母数字或连字符",
    "wizard.imageRequired": "镜像必填",
    "wizard.replicasRequired": "至少需要一个副本",
    "wizard.tpuHint": "选择切片形状；将根据算子的拓扑目录校验。",
    "wizard.dataSource": "数据源", "wizard.codeSource": "代码源",
    "wizard.elastic": "弹性", "wizard.elasticHint": "原地扩缩容且不丢失切片",
    "sheets.title": "数据表", "sheets.use": "用于任务",
    "sheets.noData": "暂无数据源", "sheets.noCode": "暂无代码源",
    "errors.backHome": "返回任务列表",
    "errors.forbidden": "您没有权限查看此页面。",
    "errors.notFound": "页面不存在。",
    "errors.serverError": "服务器出现错误。",
  },
  pt: {
    "nav.jobs": "Tarefas", "nav.create": "Criar", "nav.submit": "Enviar",
    "nav.notebooks": "Notebooks", "nav.workspaces": "Espaços",
    "nav.datasheets": "Planilhas", "nav.datasources": "Dados",
    "nav.codesources": "Código", "nav.cluster": "Cluster",
    "nav.logout": "sair",
    "jobs.title": "Tarefas de treino", "jobs.stop": "parar",
    "jobs.delete": "excluir", "jobs.archived": "arquivadas",
    "jobs.allKinds": "todos os tipos", "jobs.allStatuses": "todos os estados",
    "detail.pods": "Pods", "detail.events": "Eventos", "detail.logs": "Logs",
    "detail.manifest": "Manifesto", "detail.replicas": "Réplicas",
    "detail.autoRefresh": "atualizando durante a execução",
    "submit.title": "Enviar tarefa", "submit.form": "Formulário",
    "submit.yaml": "YAML", "submit.create": "Enviar",
    "submit.preview": "Pré-visualizar manifesto",
    "notebooks.title": "Notebooks", "notebooks.create": "Novo notebook",
    "workspaces.title": "Espaços de trabalho",
    "workspaces.create": "Novo espaço",
    "sources.data": "Fontes de dados", "sources.code": "Fontes de código",
    "sources.add": "Adicionar", "sources.save": "Salvar",
    "sources.edit": "editar",
    "cluster.title": "Cluster",
    "nav.playground": "Playground",
    "playground.title": "Playground de inferência",
    "playground.none": "nenhum objeto Inference implantado",
    "playground.target": "Modelo", "playground.maxTokens": "Máx. tokens",
    "playground.temperature": "Temperatura",
    "playground.placeholder": "Diga algo\u2026",
    "playground.send": "Enviar", "playground.clear": "Limpar",
    "playground.stop": "Parar",
    "playground.stopSeq": "Sequências de parada",
    "playground.stopHint": "separadas por vírgula",
    "nav.admin": "Admin", "admin.title": "Usuários do console",
    "admin.username": "Usuário", "admin.password": "Senha",
    "admin.role": "Papel", "admin.add": "Adicionar ou atualizar",
    "login.title": "Entrar", "login.button": "Entrar",
    "login.failed": "falha no login",
    "wizard.title": "Criar tarefa", "wizard.basics": "Básico",
    "wizard.replicas": "Réplicas", "wizard.tpu": "Fatia TPU",
    "wizard.review": "Revisão", "wizard.back": "Voltar",
    "wizard.next": "Avançar", "wizard.created": "Tarefa criada",
    "wizard.nameRequired": "nome é obrigatório",
    "wizard.nameInvalid": "nome deve ser alfanumérico minúsculo ou hífens",
    "wizard.imageRequired": "imagem é obrigatória",
    "wizard.replicasRequired": "pelo menos uma réplica",
    "wizard.tpuHint": "Escolha a forma da fatia; validada contra o catálogo de topologias do operador.",
    "wizard.dataSource": "Fonte de dados", "wizard.codeSource": "Fonte de código",
    "wizard.elastic": "Elástico", "wizard.elasticHint": "redimensiona no lugar sem perder a fatia",
    "sheets.title": "Planilhas", "sheets.use": "usar em tarefa",
    "sheets.noData": "nenhuma fonte de dados", "sheets.noCode": "nenhuma fonte de código",
    "errors.backHome": "voltar às tarefas",
    "errors.forbidden": "Você não tem permissão para ver esta página.",
    "errors.notFound": "Esta página não existe.",
    "errors.serverError": "Algo deu errado no servidor.",
  },
};

const LANGS = ["en", "zh", "pt"];
const LANG_LABEL = { en: "EN", zh: "中文", pt: "PT" };
let lang = localStorage.getItem("kubedl-lang") || "en";
if (!LANGS.includes(lang)) lang = "en";

export function t(key) {
  return (MESSAGES[lang] && MESSAGES[lang][key]) || MESSAGES.en[key] || key;
}

export function nextLang(cur) {
  return LANGS[(LANGS.indexOf(cur) + 1) % LANGS.length];
}

function applyLangToChrome() {
  document.querySelectorAll("[data-i18n]").forEach(el => {
    el.textContent = t(el.dataset.i18n);
  });
  document.getElementById("lang").textContent = LANG_LABEL[nextLang(lang)];
}

// -------------------------------------------------------------------- router

const app = document.getElementById("app");

const routes = {
  "login": viewLogin,
  "jobs": viewJobs,
  "job": viewJobDetail,
  "submit": viewSubmit,
  "notebooks": viewNotebooks,
  "notebook-create": viewNotebookCreate,
  "workspaces": viewWorkspaces,
  "workspace-create": viewWorkspaceCreate,
  "datasources": viewDataSources,
  "codesources": viewCodeSources,
  "cluster": viewCluster,
  "admin": viewAdmin,
  "job-create": viewJobCreate,
  "datasheets": viewDataSheets,
  "playground": viewPlayground,
  "403": view403,
  "404": view404,
  "500": view500,
};

export async function route() {
  const hash = location.hash.replace(/^#\//, "") || "jobs";
  const name = hash.split("?")[0];
  // unknown routes get a real 404 page (reference pages/404.jsx), not a
  // silent fall-through to the jobs list
  const view = routes[name] || view404;
  if (name !== "login") {
    document.getElementById("nav").hidden = false;
    document.getElementById("logout").hidden = false;
    try {
      const u = await api("/current-user");
      document.getElementById("user").textContent = u.loginId;
      document.getElementById("nav-admin").hidden = !u.admin;
    } catch (e) { return; /* redirected to login */ }
  }
  document.querySelectorAll("nav a").forEach(a =>
    a.classList.toggle("active", a.getAttribute("href") === "#/" + name));
  try { await view(app); }
  catch (e) {
    if (e.status === 403) return view403(app);   // reference pages/403.jsx
    if (e.message !== "auth")
      app.innerHTML = `<div class="panel error">error: ${esc(e.message)}</div>`;
  }
}

document.getElementById("lang").onclick = () => {
  lang = nextLang(lang);
  localStorage.setItem("kubedl-lang", lang);
  applyLangToChrome();
  route();
};
document.getElementById("logout").onclick = async () => {
  await api("/logout", { method: "POST" });
  location.hash = "#/login";
};
window.addEventListener("hashchange", route);
applyLangToChrome();
route();
